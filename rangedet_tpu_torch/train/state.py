"""Train state, counterpart of ``rangedet_tpu/train/state.py``: the model
(parameters and BatchNorm running statistics), the optimizer (momentum
buffers), the LR schedule and the count of steps taken."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .schedule import build_optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(model: torch.nn.Module, cfg, steps_per_epoch: int,
                       seed: Optional[int] = 0) -> TrainState:
    """Seeded initialisation (``RangeDet.init_from``, on a model still on
    the CPU) unless ``seed`` is None (weights already set), then the SGD
    optimizer over every parameter of ``model``."""
    if seed is not None:
        model.init_from(torch.Generator().manual_seed(seed))
    opt, sched = build_optimizer(cfg, model.parameters(), steps_per_epoch)
    return TrainState(model, opt, sched)
