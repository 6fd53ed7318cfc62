"""setup_s: seconds from the process's start to the window's first step:
imports, the kernel library (built on a checkout's first run), the
weights and the batch pool on the card, and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
