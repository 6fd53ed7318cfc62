"""train.targets_ms: device ms a step of the work launched inside the train
step's "targets" range (``train/train_step.py``), kernels matched to their
launches by correlation id."""


def read(ctx):
    return ctx.trace.range_ms("targets") if ctx.trace else None
