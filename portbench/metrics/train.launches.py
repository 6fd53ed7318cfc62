"""train.launches: kernels a step launched inside the train step's
"train_step" range (``train/train_step.py``; copies and sets left out),
on any thread, matched to their launch calls by CUPTI's correlation id."""
from portbench import spans


def read(ctx):
    return spans.launches(ctx.trace, ("train_step",))
