"""eval.topk_decode_ms: device ms a step of the work launched inside the
eval step's "topk" and "decode" ranges (``models/detector.py:
run_inference``): the scores' sigmoid and level concat, the mask, the
stable sort and the gathers, then the boxes' decode."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx.trace, ("topk", "decode"))
