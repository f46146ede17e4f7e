"""The SVD denoise step's share of the card's bf16 peak: one UNet forward
over the step's rows, counted from the configuration's shapes
(``arith_svd.unet_forward_flops``), over the mean step of
``unet_step_ms`` and 989 TFLOP/s, in percent."""

from portbench import arith, arith_svd
from portbench.metrics._stages import stage_values


def read(ctx):
    steps = stage_values(ctx, "unet_steps")
    if not steps:
        return None
    mix = ctx.mix
    h, w = arith_svd.latent_hw(ctx.config, mix["height"], mix["width"])
    flops = arith_svd.unet_forward_flops(ctx.config, arith_svd.unet_rows(mix), h, w,
                                         mix["num_frames"])
    return 100.0 * flops / (sum(steps) / len(steps)) / arith.PEAK_BF16_FLOPS
