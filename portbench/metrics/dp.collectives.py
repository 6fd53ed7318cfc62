"""dp.collectives: NCCL kernels launched on rank 0's card a traced step
(``trace.Trace.collective_launches``); one a collective. None where no
collective ran."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.collective_launches:
        return None
    return t.collective_launches / t.steps
