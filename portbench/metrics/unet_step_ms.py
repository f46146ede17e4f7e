"""Mean milliseconds of one SVD denoise step (the CFG pair of UNet
forwards, the guidance and the Euler step) over every step of the window's
requests (``stage_times["unet_steps"]``)."""

from portbench.metrics._stages import mean_ms


def read(ctx):
    return mean_ms(ctx, "unet_steps")
