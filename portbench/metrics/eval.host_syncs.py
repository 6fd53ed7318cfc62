"""eval.host_syncs: waits of the host for the card a step inside the eval
step, its "host_sync" ranges (``ops/nms.py:weighted_nms``'s check whether
any frame has work left: its rounds plus one a class)."""
from portbench import spans


def read(ctx):
    return spans.count(ctx.trace, "host_sync", "postprocess")
