"""The SVD UNet's spatial self-attention kernels' share of their roofline:
each launch's least time (``arith_svd.self_attention_bound_s`` at its
level's tokens and heads over the step's rows) over the device time of K6
and K1 (modes 3 and 0 of ``csrc/flash_attention_hopper.cu``'s template,
told apart by the kernel's name), in percent.  A forward's launches of each
kernel are those ``arith_svd.attention_kernel`` gives its self-attention
calls; the temporal, cross and mid-block attention run outside them and are
not counted."""

import sys

from portbench import arith_svd

KERNELS = {"K6": r"flash_attention_hopper_kernel<\s*64,\s*\d+,\s*\d+,\s*3\s*>",
           "K1": r"flash_attention_hopper_kernel<\s*64,\s*\d+,\s*\d+,\s*0\s*>"}


def read(ctx):
    if ctx.trace is None:
        return None
    mix = ctx.mix
    h, w = arith_svd.latent_hw(ctx.config, mix["height"], mix["width"])
    rows = arith_svd.unet_rows(mix)
    calls = arith_svd.self_attention_calls(ctx.config, h, w)
    bound = seconds = 0.0
    for kernel, pattern in KERNELS.items():
        mine = [c for c in calls if arith_svd.attention_kernel(*c) == kernel]
        s, n = ctx.trace.kernel_seconds(pattern)
        if not mine or not n:
            continue
        print(f"portbench: {__name__}: {kernel} {n} launches, {s!r} s: "
              f"{ctx.trace.kernel_names(pattern)}", file=sys.stderr)
        bound += n / len(mine) * sum(arith_svd.self_attention_bound_s(t, hd, rows)
                                     for t, hd in mine)
        seconds += s
    return 100.0 * bound / seconds if seconds else None
