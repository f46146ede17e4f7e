"""Mean milliseconds of a window request's T5 encode (``stage_times``)."""

from portbench.metrics._stages import mean_ms


def read(ctx):
    return mean_ms(ctx, "t5_encode")
