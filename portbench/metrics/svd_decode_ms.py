"""Mean milliseconds of a window request's temporal VAE decode, all its
frames at once (``stage_times["vae_decode"]``)."""

from portbench.metrics._stages import mean_ms


def read(ctx):
    return mean_ms(ctx, "vae_decode")
