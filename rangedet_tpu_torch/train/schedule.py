"""LR schedule and optimizer, counterpart of the ``lr_mode="cosine"`` /
``optimizer="sgd"`` branch of ``rangedet_tpu/train/schedule.py`` (reference
tools/train.py:330-368: clip_gradient=35, wd=1e-5, momentum=0.9; cosine
decay with a linear warmup from warmup_lr).

The JAX optimizer is optax.chain(clip(35), add_decayed_weights(1e-5),
sgd(schedule, momentum=0.9)). Here that is an elementwise clamp of every
gradient, then ``torch.optim.SGD`` with weight_decay and momentum (no
dampening, no Nesterov), whose update is the same: buf = g + wd*p +
momentum*buf, p -= lr*buf, with buf starting at 0. The LR of update n (from
0) is schedule(n). Other modes and optimizers are not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def build_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(warmup_lr, base_lr, warmup_steps,
    total_steps, end_value=0): linear warmup, then cosine decay to 0."""
    if cfg.lr_mode != "cosine":
        raise NotImplementedError(f"lr_mode {cfg.lr_mode!r} is not ported")
    total = max(1, (cfg.end_epoch - cfg.begin_epoch) * steps_per_epoch)
    # clamp: short smoke runs can have warmup >= total
    warmup = min(int(cfg.warmup_epochs * steps_per_epoch), total - 1)
    init, peak = cfg.warmup_lr, cfg.base_lr
    decay = total - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return init + (peak - init) * count / warmup
        t = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                    steps_per_epoch: int):
    """-> (torch.optim.SGD, schedule). Clip the gradients with
    ``clip_gradients`` and set the LR with ``set_lr`` before each step."""
    if cfg.optimizer != "sgd":
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not ported")
    if cfg.clip_mode != "elementwise":
        raise NotImplementedError(f"clip_mode {cfg.clip_mode!r} is not ported")
    sched = build_schedule(cfg, steps_per_epoch)
    opt = torch.optim.SGD(params, lr=sched(0), momentum=cfg.momentum,
                          dampening=0.0, weight_decay=cfg.weight_decay,
                          nesterov=False)
    return opt, sched


def clip_gradients(params: Iterable[torch.nn.Parameter], clip: float) -> None:
    """MXNet clip_gradient: each gradient element clamped to [-clip, clip]."""
    for p in params:
        if p.grad is not None:
            p.grad.clamp_(-clip, clip)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
