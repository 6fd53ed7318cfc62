"""LR and momentum schedules and the optimizer, counterpart of
``rangedet_tpu/train/schedule.py`` (reference utils/lr_scheduler.py and
utils/train_utils.py: OneCycleScheduler :28-62, OneCycleMomentumScheduler
:65-93, clip_global_norm :96-137, AdamW/AdamWS :140-302). The recipes ship
cosine decay with a linear warmup and SGD (tools/train.py:330-368:
clip_gradient=35, wd=1e-5, momentum=0.9).

The JAX optimizer is an optax chain: a clip (elementwise, or by the global
norm), then for ``sgd`` add_decayed_weights(wd) + sgd(schedule, momentum),
for ``adamw`` / ``adamws`` adamw(schedule, b2, wd), and for ``adamws`` a
per-output-filter standardization of the conv kernels after the update.
Here the clip is ``clip_gradients`` on the gradients, then
``torch.optim.SGD`` (weight decay, momentum, no dampening, no Nesterov:
buf = g + wd*p + momentum*buf from buf = 0, p -= lr*buf) or
``torch.optim.AdamW`` (eps 1e-8 outside the square root, p *= 1 - lr*wd,
bias correction with the current beta1), then ``standardize_``. Update n
(from 0) runs at schedule(n) and, with ``lr_mode="onecycle"``, at SGD
momentum or Adam beta1 momentum_schedule(n), as optax's inject_hyperparams
reads them. The schedules are python floats; JAX evaluates them in f32.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

Schedule = Callable[[int], float]
STD_EPS = 1e-10  # weight_standardize_after_update's eps


def _annealing_cos(start: float, end: float, pct: float) -> float:
    """Cosine anneal start -> end as pct goes 0 -> 1 (the reference's
    OneCycleScheduler.annealing_cos, utils/train_utils.py:46-52)."""
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def onecycle_schedule(total_steps: int, peak: float, div_factor: float = 10.0,
                      pct_start: float = 0.4,
                      final_div: float = 1e4) -> Schedule:
    """OneCycleScheduler (utils/train_utils.py:28-62): cosine low -> peak
    over the first pct_start of training, then peak -> low / final_div,
    with low = peak / div_factor."""
    warmup = max(1, int(total_steps * pct_start))
    low = peak / div_factor
    rest = max(total_steps - warmup, 1)

    def sched(count: int) -> float:
        if count <= warmup:
            return _annealing_cos(low, peak, count / warmup)
        return _annealing_cos(peak, low / final_div, (count - warmup) / rest)

    return sched


def onecycle_momentum_schedule(total_steps: int,
                               moms: Sequence[float] = (0.95, 0.85),
                               pct_start: float = 0.4) -> Schedule:
    """OneCycleMomentumScheduler (utils/train_utils.py:65-93): momentum
    anneals high -> low while the LR rises, then low -> high."""
    warmup = max(1, int(total_steps * pct_start))
    rest = max(total_steps - warmup, 1)

    def sched(count: int) -> float:
        if count <= warmup:
            return _annealing_cos(moms[0], moms[1], count / warmup)
        return _annealing_cos(moms[1], moms[0], (count - warmup) / rest)

    return sched


def _linear(init: float, end: float, steps: int, power: float = 1.0
            ) -> Schedule:
    """optax.polynomial_schedule (linear_schedule at power 1): init -> end
    over ``steps`` counts, then end."""
    def sched(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end

    return sched


def _after_warmup(cfg, warmup: int, sched: Schedule) -> Schedule:
    """optax.join_schedules([linear warmup, sched], [warmup]): the later
    schedule counts from the warmup's end."""
    if warmup == 0:
        return sched
    warm = _linear(cfg.warmup_lr, cfg.base_lr, warmup)
    return lambda count: warm(count) if count < warmup else sched(
        count - warmup)


def build_schedule(cfg, steps_per_epoch: int) -> Schedule:
    """The LR of update n, ``lr_mode`` cosine (optax's
    warmup_cosine_decay_schedule to 0), step (x0.1 at each of ``lr_steps``
    epochs, counted after the warmup), poly (power 2 to 0 after the
    warmup), constant (no warmup) or onecycle (no warmup)."""
    total = max(1, (cfg.end_epoch - cfg.begin_epoch) * steps_per_epoch)
    # clamp: short smoke runs can have warmup >= total
    warmup = min(int(cfg.warmup_epochs * steps_per_epoch), total - 1)
    peak = cfg.base_lr
    if cfg.lr_mode == "cosine":
        decay = total - warmup

        def cosine(count: int) -> float:
            t = min(count, decay)
            return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return _after_warmup(cfg, warmup, cosine)
    if cfg.lr_mode == "step":
        # a dict, as JAX's: epochs that land on one count drop once
        bounds = sorted({int(e * steps_per_epoch) for e in cfg.lr_steps})

        def step(count: int) -> float:
            return peak * 0.1 ** sum(count >= b for b in bounds)

        return _after_warmup(cfg, warmup, step)
    if cfg.lr_mode == "poly":
        return _after_warmup(cfg, warmup,
                             _linear(peak, 0.0, total - warmup, power=2))
    if cfg.lr_mode == "constant":
        return lambda count: peak
    if cfg.lr_mode == "onecycle":
        return onecycle_schedule(total, peak,
                                 div_factor=cfg.onecycle_div_factor,
                                 pct_start=cfg.onecycle_pct_start)
    raise ValueError(f"unknown lr_mode {cfg.lr_mode}")


def build_momentum_schedule(cfg, steps_per_epoch: int) -> Optional[Schedule]:
    """With ``lr_mode="onecycle"`` the SGD momentum / Adam beta1 of update
    n; otherwise None (fixed: ``cfg.momentum`` / 0.9)."""
    if cfg.lr_mode != "onecycle":
        return None
    total = max(1, (cfg.end_epoch - cfg.begin_epoch) * steps_per_epoch)
    return onecycle_momentum_schedule(total, moms=cfg.onecycle_moms,
                                      pct_start=cfg.onecycle_pct_start)


# a kernel that AdamWS standardizes and the dims reduced per output filter
Standardized = Tuple[torch.nn.Parameter, Tuple[int, ...]]


def standardized_params(model: torch.nn.Module) -> List[Standardized]:
    """The parameters whose JAX leaf is 4-D (weight_standardize_after_update
    standardizes those, HWIO over (0, 1, 2)): every 3x3 conv kernel,
    ``conv2_weight``, ``meta_agg``'s (1, 1, 9C, Co) kernel and the deconv
    kernels, the last reduced over (Ci, kh, kw) = dims (0, 2, 3) of the
    port's (Ci, Co, kh, kw). Not the 1x1 ``sc_weight`` and head projections,
    which are (Ci, Co) in JAX, nor ``nn.Linear`` weights."""
    from ..convert import flax_ndim

    out = []
    for name, p in model.named_parameters():
        if flax_ndim(name, tuple(p.shape)) != 4:
            continue
        deconv = name.rsplit(".", 2)[-2].endswith("_deconv")
        out.append((p, (0, 2, 3) if deconv else (1, 2, 3)))
    return out


@torch.no_grad()
def standardize_(kernels: Iterable[Standardized],
                 eps: float = STD_EPS) -> None:
    """AdamWS's step after the update (utils/train_utils.py:289-302): each
    kernel to per-output-filter mean 0 and standard deviation 1 (the
    population's, plus eps)."""
    for w, dims in kernels:
        mean = w.mean(dim=dims, keepdim=True)
        std = (w - mean).square().mean(dim=dims, keepdim=True).sqrt() + eps
        w.copy_((w - mean) / std)


def build_optimizer(cfg, model: torch.nn.Module, steps_per_epoch: int
                    ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """-> (torch.optim.SGD or AdamW over every parameter of ``model``, LR
    schedule). The step clips the gradients with ``clip_gradients``, sets
    the LR (and onecycle's momentum) with ``set_hyperparams`` before each
    update, and for ``adamws`` runs ``standardize_`` after it."""
    if cfg.clip_mode not in ("elementwise", "global_norm"):
        raise ValueError(f"unknown clip_mode {cfg.clip_mode}")
    sched = build_schedule(cfg, steps_per_epoch)
    mom = build_momentum_schedule(cfg, steps_per_epoch)
    params = list(model.parameters())
    if cfg.optimizer == "sgd":
        opt = torch.optim.SGD(
            params, lr=sched(0),
            momentum=mom(0) if mom is not None else cfg.momentum,
            dampening=0.0, weight_decay=cfg.weight_decay, nesterov=False)
    elif cfg.optimizer in ("adamw", "adamws"):
        b1 = mom(0) if mom is not None else 0.9  # optax.adamw's b1
        opt = torch.optim.AdamW(params, lr=sched(0),
                                betas=(b1, cfg.adam_beta2), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    return opt, sched


def clip_gradients(params: Iterable[torch.nn.Parameter], clip: float,
                   mode: str = "elementwise") -> None:
    """``elementwise``: MXNet's clip_gradient, each element clamped to
    [-clip, clip]. ``global_norm``: optax.clip_by_global_norm, every
    gradient scaled by clip / ||g|| when the norm ||g|| over all of them
    is at least clip; on the card, with no wait for the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if mode == "elementwise":
        for g in grads:
            g.clamp_(-clip, clip)
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    torch._foreach_mul_(grads, scale)


def set_hyperparams(opt: torch.optim.Optimizer, lr: float,
                    momentum: Optional[float] = None) -> None:
    """The LR, and the momentum (SGD) or beta1 (Adam) when given, of every
    parameter group."""
    for group in opt.param_groups:
        group["lr"] = lr
        if momentum is None:
            continue
        if "betas" in group:
            group["betas"] = (momentum, group["betas"][1])
        else:
            group["momentum"] = momentum
