"""eval.wnms_rounds: rounds of the weighted NMS's loop a step, the
"wnms.round" ranges of ``ops/nms.py:weighted_nms`` (each selects the next
block of alive candidates, their IoU rows, greedy chain, voting and
scatter; frames of a batch share a round)."""
from portbench import spans


def read(ctx):
    return spans.count(ctx.trace, "wnms.round", "wnms")
