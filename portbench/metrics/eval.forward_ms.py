"""eval.forward_ms: device ms a step of the work launched between the
forward pre-hook and hook the harness registers on the model (its
"portbench.forward" range)."""


def read(ctx):
    return ctx.trace.range_ms("portbench.forward") if ctx.trace else None
