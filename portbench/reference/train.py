"""Plain RangeDet training steps: targets, forward in train mode, losses,
gradients, the elementwise clip and SGD with momentum and weight decay at
the cosine schedule's learning rate (the authors' tools/train.py: clip 35,
wd 1e-5, momentum 0.9).

SGD (MXNet / optax form): d = clip(g) + wd p; buf = d on the first update,
else momentum buf + d; p -= lr(n) buf. Cosine without warmup: lr(n) =
base_lr (1 + cos(pi n / total)) / 2 over total = (end_epoch - begin_epoch)
* steps_per_epoch updates.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from .losses import losses
from .model import Net, Params, is_trainable, update_running_stats
from .targets import build_targets


def learning_rate(c: dict, steps_per_epoch: int, n: int) -> float:
    total = max(1, (c["end_epoch"] - c["begin_epoch"]) * steps_per_epoch)
    return c["base_lr"] * 0.5 * (1.0 + math.cos(math.pi * min(n, total)
                                                / total))


# the backbone stages whose first-step outputs the check compares
STAGES1 = ("res1", "res2a", "res2", "res3a", "res3", "agg3")


def first_forward(P0: Params, c: dict, batch: Dict[str, torch.Tensor],
                  cast=None) -> dict:
    """The first step's forward alone, without gradients: {"losses": [its
    total loss], "forward1", "stages1"} as ``train_steps`` gives them
    (for the control at sizes where a backward in fp8 would not fit)."""
    kw = {} if cast is None else {"cast": cast}
    with torch.no_grad():
        net = Net(P0, c, train=True, keep=STAGES1, **kw)
        cls, reg = net(batch["input_data"], batch["coord"])
        total, _ = losses(cls, reg, build_targets(batch, c), c)
    return {"losses": [float(total)], "forward1": (cls, reg),
            "stages1": net.kept}


def train_steps(P0: Params, c: dict, steps_per_epoch: int,
                batches: List[Dict[str, torch.Tensor]], cast=None) -> dict:
    """Run len(batches) updates from the parameters P0 (not modified).
    Returns {"losses": [total loss of each step], "forward1": the first
    step's (logits, deltas), "stages1": {stage: its output (B, C, H, W)}
    of the first step for the stages of ``STAGES1``, "grad1": {name: the
    clipped gradient of update 1}, "params": {name: parameters after the
    last update}}.
    ``cast``: the rounding of the control (``reference.precision``)."""
    if c["optimizer"] != "sgd" or c["clip_mode"] != "elementwise" \
            or c["lr_mode"] != "cosine" or c["warmup_epochs"] != 0:
        raise ValueError("the reference trains SGD with the elementwise "
                         "clip at a cosine LR without warmup")
    P = {k: v.detach().clone() for k, v in P0.items()}
    names = [k for k in P if is_trainable(k)]
    bufs: Dict[str, torch.Tensor] = {}
    out = {"losses": [], "forward1": None, "stages1": None, "grad1": None,
           "params": None}
    kw = {} if cast is None else {"cast": cast}
    for n, batch in enumerate(batches):
        for k in names:
            P[k].requires_grad_(True)
        targets = build_targets(batch, c)
        net = Net(P, c, train=True, keep=STAGES1 if n == 0 else (), **kw)
        cls, reg = net(batch["input_data"], batch["coord"])
        total, _ = losses(cls, reg, targets, c)
        grads = torch.autograd.grad(total, [P[k] for k in names])
        del targets
        lr = learning_rate(c, steps_per_epoch, n)
        with torch.no_grad():
            clipped = {}
            for k, g in zip(names, grads):
                g = g.clamp(-c["clip_gradient"], c["clip_gradient"])
                clipped[k] = g
                d = g + c["weight_decay"] * P[k]
                bufs[k] = d if n == 0 else c["momentum"] * bufs[k] + d
            for k in names:
                P[k] = P[k].detach() - lr * bufs[k]
            update_running_stats(P, net.stats)
        out["losses"].append(float(total.detach()))
        if n == 0:
            out["grad1"] = clipped
            out["forward1"] = ([t.detach() for t in cls],
                               [t.detach() for t in reg])
            out["stages1"] = net.kept
        del grads, total, net, cls, reg
    out["params"] = {k: P[k].detach() for k in names}
    return out
