"""eval.meta_taps_roofline: the least time of an eval forward's
Meta-Kernel taps (kernel 7, the "taps" mode of the forward kernel;
``portbench.work``, tensor-core bound) over the device time of its
launches, in %. In eval the forward kernel runs in this mode alone."""
from portbench import work

KERNELS = ("meta_fwd_kernel",)


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS) if ctx.trace else None
    if not t:
        return None
    return 100.0 * work.meta_taps_bound_s(
        ctx.c, ctx.traffic["frames_per_card"]) / t
