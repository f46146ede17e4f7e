"""The denoise step's share of the card's bf16 peak: one DiT forward's
FLOPs, counted from the configuration's shapes (``arith``), over the mean
step time of ``denoise_step_ms`` and 989 TFLOP/s, in percent."""

from portbench import arith
from portbench.metrics._stages import stage_values


def read(ctx):
    steps = stage_values(ctx, "denoise_steps")
    if not steps:
        return None
    mix = ctx.mix
    lf, lh, lw = arith.latent_shape(ctx.config, mix["height"], mix["width"], mix["num_frames"])
    flops = arith.dit_forward_flops(ctx.config, lf * lh * lw, mix["prompt_tokens"])
    return 100.0 * flops / (sum(steps) / len(steps)) / arith.PEAK_BF16_FLOPS
