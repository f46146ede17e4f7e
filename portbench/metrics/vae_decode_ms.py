"""Mean milliseconds of a window request's VAE decode (``stage_times``), in
the mode the decode policy picked."""

from portbench.metrics._stages import mean_ms


def read(ctx):
    return mean_ms(ctx, "vae_decode")
