"""The VAE decoder's 3x3x3 convs' share of their roofline: the least time
of every conv of the decodes of the traced half of the window (``arith.decoder_convs``,
``arith.conv_bound_s``) over the device time of the conv kernels, cuDNN's
or K8's (``csrc/conv3d_igemm.cu``), in percent."""

import sys

from portbench import arith

KERNELS = r"fprop|conv3d_igemm|convolve|conv2d|conv3d|implicit_gemm"
EXCLUDE = r"copy|elementwise|reduce"


def read(ctx):
    if ctx.trace is None or not ctx.traced_requests:
        return None
    seconds, launches = ctx.trace.kernel_seconds(KERNELS, EXCLUDE)
    if not launches:
        return None
    print(f"portbench: {__name__}: {launches} launches, {seconds!r} s: "
          f"{ctx.trace.kernel_names(KERNELS, EXCLUDE)}", file=sys.stderr)
    mix = ctx.mix
    lat = arith.latent_shape(ctx.config, mix["height"], mix["width"], mix["num_frames"])
    bound = sum(arith.conv_bound_s(*c) for c in arith.decoder_convs(ctx.config, *lat))
    return 100.0 * ctx.traced_requests * bound / seconds
