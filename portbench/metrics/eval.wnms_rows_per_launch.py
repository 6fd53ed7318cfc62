"""eval.wnms_rows_per_launch: the weighted NMS's rows a step (frames x
classes) over the launches a step of the weighted-NMS kernel
(``csrc/wnms.cu``'s ``wnms_kernel``) in the device trace: how many rows
one launch carries side by side, one block a row. None where no such
kernel ran."""
KERNEL = "wnms_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    launches = sum(KERNEL in name for name, _, _, _ in tr.device)
    if not launches:
        return None
    rows = ctx.window.frames_per_step * int(ctx.c["num_classes"])
    return rows * tr.steps / launches
