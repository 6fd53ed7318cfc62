"""The share of a step in which no kernel, copy or set runs on the card:
100 minus the device's busy time a step (the union of its intervals over
the traced steps, divided by their count) over the time a step of the
untraced steps that follow takes. The profiler slows the host's dispatch
of the traced steps (about 2x on the train step), so their own window
would read the card idler than an untraced step leaves it; ``device``'s
``busy_s`` and ``window_s`` keep the traced window's own numbers."""


def read(ctx):
    t, w = ctx.trace, ctx.window
    if t is None or not w.steps or not w.seconds:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.steps) / (w.seconds / w.steps))
