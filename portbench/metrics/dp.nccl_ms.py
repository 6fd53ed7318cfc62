"""dp.nccl_ms: device ms a traced step of NCCL's kernels on rank 0's card
(``trace.Trace.collective_s``): the BatchNorms' all-reduces forward and
backward, the loss normalizers, the flat buffers of gradients and running
statistics, each kernel's wait for the slowest rank included, as the
profiler sees them. None where no collective ran."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.collective_launches:
        return None
    return 1e3 * t.collective_s / t.steps
