"""train.forward_ms: device ms a step of the work launched inside the train
step's "forward" range (``train/train_step.py``), kernels matched to their
launches by correlation id."""


def read(ctx):
    return ctx.trace.range_ms("forward") if ctx.trace else None
