"""eval.postprocess_ms: host ms a step of the eval step's post-processing
alone: top-k, decode, the weighted NMS's host loop and the copy of the
boxes to the host. It is read on ``run.POST_STEPS`` steps that a traced
run makes after its window, each of which waits at the forward's hook
until the forward's kernels have finished, and runs from there until the
boxes are on the host; the mean over those steps."""
import statistics


def read(ctx):
    ms = getattr(ctx.window, "post_ms", None)
    return statistics.fmean(ms) if ms else None
