"""The train step, counterpart of ``make_train_step`` in
``rangedet_tpu/train/train_step.py``. The Meta-Kernel block is the one the
config selects: the recipes set ``use_pallas_meta=True``, the fused block
(the meta_stats, meta_agg and block-backward kernels, the 9C taps never
materialized); the base config's ``use_pallas_meta=False`` selects the
materialized block.

One step: on-device targets -> forward in train mode (BatchNorm on batch
statistics, running statistics updated) -> IoU-aware VFL + normalized
smooth-L1 -> backward -> elementwise clip -> SGD with momentum and weight
decay at the schedule's LR. The 3x3 convs run the conv3x3 forward, dgrad
and wgrad kernels, the IoU target its own kernel (``ops/``). Each stage is
a ``record_function`` range, which ``tools/profile_train.py`` reads.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.profiler import record_function

from ..models.detector import build_train_targets, compute_losses
from .schedule import clip_gradients, set_lr
from .state import TrainState


def make_train_step(state: TrainState, cfg
                    ) -> Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """Returns step(batch) -> metrics {cls_loss_s{s}, reg_loss_s{s},
    total_loss} (detached f32 scalars of the forward before the update).
    The step updates ``state`` in place: parameters, BatchNorm running
    statistics, momentum buffers and the step count. batch holds device
    tensors, channels last (see build_train_targets)."""
    model, opt = state.model, state.optimizer
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        with record_function("targets"):
            targets = build_train_targets(batch, cfg)
        with record_function("forward"):
            cls_logits, reg_deltas = model(batch["input_data"],
                                           batch["coord"])
        with record_function("losses"):  # the IoU target included
            total, metrics = compute_losses(cls_logits, reg_deltas, targets,
                                            cfg)
        with record_function("backward"):
            opt.zero_grad(set_to_none=True)
            total.backward()
        with record_function("optimizer"):
            clip_gradients(params, cfg.clip_gradient)
            set_lr(opt, state.schedule(state.step))
            opt.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def batch_to_device(batch: Dict, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch -> tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
