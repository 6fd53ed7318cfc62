"""eval_frames_per_s: frames whose boxes reached the host in the window,
over the window's seconds."""


def read(ctx):
    if ctx.mode != "eval":
        return None
    return ctx.window.frames / ctx.window.seconds
