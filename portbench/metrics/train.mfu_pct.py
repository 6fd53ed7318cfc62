"""train.mfu_pct: forward and backward contraction FLOPs a frame
(``portbench.work``: three forwards, recompute not counted) times the
frames of the traced run's untraced steps (of every card), over their
seconds, over the bf16 peak of the cards the cell uses (989 TFLOP/s
each)."""
from portbench import work


def read(ctx):
    w = ctx.window
    if ctx.mode != "train" or not w.seconds:
        return None
    return 100.0 * work.train_flops(ctx.c) * w.frames / w.seconds \
        / (work.PEAK_BF16 * ctx.chips)
