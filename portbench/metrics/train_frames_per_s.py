"""train_frames_per_s: frames whose update finished in the window, over
the window's seconds; the window ends on ``torch.cuda.synchronize()``."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.window.frames / ctx.window.seconds
