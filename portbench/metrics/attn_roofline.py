"""The DiT self-attention kernels' share of their roofline: each launch's
least time (``arith.self_attention_bound_s`` at the cell's tokens) over the
device time of the kernels named here (K1 and K2, the online and the
fixed-shift modes of ``csrc/flash_attention_hopper.cu``), in percent.
Cross-attention runs outside them and is not counted."""

import sys

from portbench import arith

KERNELS = r"flash_attention_hopper"


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = ctx.trace.kernel_seconds(KERNELS)
    if not launches:
        return None
    print(f"portbench: {__name__}: {launches} launches, {seconds!r} s: "
          f"{ctx.trace.kernel_names(KERNELS)}", file=sys.stderr)
    mix = ctx.mix
    lf, lh, lw = arith.latent_shape(ctx.config, mix["height"], mix["width"], mix["num_frames"])
    return 100.0 * launches * arith.self_attention_bound_s(ctx.config, lf * lh * lw) / seconds
