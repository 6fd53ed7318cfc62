"""train.dispatch_ms: host ms of one call of the train step (its
dispatch; it waits for the card only where the program syncs), the mean
over the traced run's untraced steps."""
import statistics


def read(ctx):
    ms = getattr(ctx.window, "call_ms", None)
    return statistics.fmean(ms) if ms else None
