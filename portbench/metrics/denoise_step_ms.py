"""Mean milliseconds of one denoise step over every step of the window's
requests (``stage_times["denoise_steps"]``)."""

from portbench.metrics._stages import mean_ms


def read(ctx):
    return mean_ms(ctx, "denoise_steps")
