"""train.meta_block_roofline: the least time of a step's fused
Meta-Kernel launches (stats, agg, the backward in both modes;
``portbench.work``, tensor-core bound) over the device time of the
kernels below, in %."""
from portbench import work

KERNELS = ("meta_fwd_kernel", "meta_bwd_kernel", "reduce_blocks_kernel")


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS) if ctx.trace else None
    if not t:
        return None
    return 100.0 * work.meta_block_bound_s(
        ctx.c, ctx.traffic["frames_per_card"]) / t
