"""The train step, counterpart of ``make_train_step`` in
``rangedet_tpu/train/train_step.py``. The Meta-Kernel block is the one the
config selects: the recipes set ``use_pallas_meta=True``, the fused block
(the meta_stats, meta_agg and block-backward kernels, the 9C taps never
materialized); the base config's ``use_pallas_meta=False`` selects the
materialized block.

One step: on-device targets -> forward in train mode (BatchNorm on batch
statistics, running statistics updated) -> IoU-aware VFL + normalized
smooth-L1 -> backward -> the clip (elementwise, or by the global norm) ->
the optimizer (SGD with momentum and weight decay, or AdamW) at the
schedule's LR and, with onecycle, its momentum -> for AdamWS the conv
kernels' standardization. The 3x3 convs run the conv3x3 forward, dgrad
and wgrad kernels, the IoU target its own kernel (``ops/``). Each stage is
a ``record_function`` range, which ``tools/profile_train.py`` reads.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.profiler import record_function

from ..models.detector import build_train_targets, compute_losses
from .schedule import clip_gradients, set_hyperparams, standardize_
from .state import TrainState


def make_train_step(state: TrainState, cfg
                    ) -> Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """Returns step(batch) -> metrics {cls_loss_s{s}, reg_loss_s{s},
    total_loss} (detached f32 scalars of the forward before the update).
    The step updates ``state`` in place: parameters, BatchNorm running
    statistics, the optimizer's state and the step count. batch holds device
    tensors, channels last (see build_train_targets)."""
    model, opt = state.model, state.optimizer

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
            apply_update(state, cfg)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def apply_update(state: TrainState, cfg) -> None:
    """Update n = ``state.step`` from the parameters' gradients: the clip,
    the LR (and with onecycle the momentum or beta1) of update n, the
    optimizer's step, AdamWS's standardization; then the count moves on."""
    clip_gradients(state.model.parameters(), cfg.clip_gradient,
                   cfg.clip_mode)
    mom = state.momentum_schedule
    set_hyperparams(state.optimizer, state.schedule(state.step),
                    mom(state.step) if mom is not None else None)
    state.optimizer.step()
    standardize_(state.standardized)
    state.step += 1


def batch_to_device(batch: Dict, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch -> tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
