"""eval.wnms_device_ms: device ms a step of the work launched inside the
eval step's "wnms" range (``models/detector.py:run_inference``): the
weighted NMS's sorts, its rounds and host syncs, and the eval rows."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx.trace, ("wnms",))
