"""eval.wnms_launches: kernels a step launched inside the eval step's
"wnms" range (copies and sets left out), matched to their launch calls by
CUPTI's correlation id."""
from portbench import spans


def read(ctx):
    return spans.launches(ctx.trace, ("wnms",))
