"""eval.mfu_pct: forward contraction FLOPs a frame (``portbench.work``)
times the frames of the traced run's untraced steps, over their seconds,
over the H100's bf16 peak."""
from portbench import work


def read(ctx):
    w = ctx.window
    if ctx.mode != "eval" or not w.seconds:
        return None
    return 100.0 * work.forward_flops(ctx.c) * w.frames / w.seconds \
        / (work.PEAK_BF16 * ctx.chips)
