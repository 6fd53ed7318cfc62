"""train.optimizer_ms: device ms a step of the work launched inside the train
step's "optimizer" range (``train/train_step.py``), kernels matched to their
launches by correlation id."""


def read(ctx):
    return ctx.trace.range_ms("optimizer") if ctx.trace else None
