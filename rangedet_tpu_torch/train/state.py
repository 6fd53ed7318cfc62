"""Train state, counterpart of ``rangedet_tpu/train/state.py``: the model
(parameters and BatchNorm running statistics), the optimizer (momentum, or
Adam's moments), the LR and momentum schedules, the kernels AdamWS
standardizes and the count of steps taken."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .schedule import (
    Schedule,
    Standardized,
    build_momentum_schedule,
    build_optimizer,
    standardized_params,
)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0
    # onecycle: the momentum / beta1 of each update; else None
    momentum_schedule: Optional[Schedule] = None
    # adamws: the kernels standardized after each update; else empty
    standardized: List[Standardized] = dataclasses.field(
        default_factory=list)


def create_train_state(model: torch.nn.Module, cfg, steps_per_epoch: int,
                       seed: Optional[int] = 0) -> TrainState:
    """Seeded initialisation (``RangeDet.init_from``, on a model still on
    the CPU) unless ``seed`` is None (weights already set), then the
    config's optimizer over every parameter of ``model``."""
    if seed is not None:
        model.init_from(torch.Generator().manual_seed(seed))
    opt, sched = build_optimizer(cfg, model, steps_per_epoch)
    return TrainState(
        model, opt, sched,
        momentum_schedule=build_momentum_schedule(cfg, steps_per_epoch),
        standardized=(standardized_params(model)
                      if cfg.optimizer == "adamws" else []))


def param_count(state: TrainState) -> int:
    """The number of trainable values of the model (tools/train.py's
    ``params: X.XXM`` line)."""
    return sum(p.numel() for p in state.model.parameters())
