"""eval.conv3x3_roofline: the least time of an eval forward's 3x3 convs
and transposed convs (``portbench.work``) over the device time of the
conv forward kernel's launches, in %."""
from portbench import work

KERNELS = ("conv3x3_gemm_kernel", "ingest_t_kernel", "reduce_rows_kernel")


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS) if ctx.trace else None
    if not t:
        return None
    return 100.0 * work.conv3x3_bound_s(
        ctx.c, ctx.traffic["frames_per_card"], train=False) / t
