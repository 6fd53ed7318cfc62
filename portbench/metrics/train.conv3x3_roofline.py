"""train.conv3x3_roofline: the least time of a step's 3x3 convs and
transposed convs (forward, data and weight gradients; ``portbench.work``)
over the device time of the conv kernels below, in %."""
from portbench import work

KERNELS = ("conv3x3_gemm_kernel", "ingest_t_kernel", "reduce_rows_kernel",
           "conv3x3_wgrad_kernel", "wgrad_ingest_kernel",
           "reduce_splits_kernel")


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS) if ctx.trace else None
    if not t:
        return None
    return 100.0 * work.conv3x3_bound_s(
        ctx.c, ctx.traffic["frames_per_card"], train=True) / t
