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
and wgrad kernels, the IoU target its own kernel (``ops/``). The step is
a profiler range (``utils/spans.py``) ``train_step``, each stage one
inside it, which ``tools/profile_train.py`` and the benchmark read.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.detector import build_train_targets, compute_losses
from ..utils.spans import span
from .schedule import clip_gradients, set_hyperparams, standardize_
from .state import TrainState


def make_train_step(state: TrainState, cfg, group=None, width_group=None
                    ) -> Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """Returns step(batch) -> metrics {cls_loss_s{s}, reg_loss_s{s},
    total_loss} (detached f32 scalars of the forward before the update).
    The step updates ``state`` in place: parameters, BatchNorm running
    statistics, the optimizer's state and the step count. batch holds device
    tensors, channels last (see build_train_targets).

    With a process ``group`` the step is data-parallel: batch holds this
    rank's rows, the losses sum their normalizers over the BatchNorms' sync
    group, and between the backward and the update the gradients, metrics
    and running statistics are reduced over ``group``
    (``parallel/dp_step.py``); the metrics are then the global batch's and
    every rank updates ``state`` identically.

    With a ``width_group`` too, batch holds this rank's columns of its
    frames (``parallel/dist.py:local_rows``), the model exchanges halos
    over it (``layers.set_width_group``) and the targets sum their per-box
    point counts over it; ``group`` is then the whole world, over which the
    BatchNorms, the loss normalizers and the reduction sum
    (``rangedet_tpu/parallel/shard_map_step.py:31-99``)."""
    model, opt = state.model, state.optimizer
    sync, reduce = None, None
    if group is not None:
        from ..parallel.dp_step import make_reduction

        sync, reduce = make_reduction(model, group)

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        with span("train_step"):
            with span("targets"):
                targets = build_train_targets(batch, cfg, width_group)
            with span("forward"):
                cls_logits, reg_deltas = model(batch["input_data"],
                                               batch["coord"])
            with span("losses"):  # the IoU target included
                total, metrics = compute_losses(cls_logits, reg_deltas,
                                                targets, cfg,
                                                sync_group=sync)
            with span("backward"):
                opt.zero_grad(set_to_none=True)
                total.backward()
            if reduce is not None:
                with span("all_reduce"):
                    metrics = reduce(metrics)
            with span("optimizer"):
                apply_update(state, cfg)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def build_train_step_fn(state: TrainState, cfg, group=None,
                        width_group=None):
    """The train step for the ranks of ``group``, as
    ``rangedet_tpu/train/train_step.py:build_train_step_fn`` picks it:

    * a width group of two or more ranks (a "model" mesh axis): the width
      step, ``make_train_step`` with both groups; it needs
      ``cfg.width_axis``, sync BatchNorm (``cfg.sync_bn``) over the whole
      world ``group`` and the model's width layers on ``width_group``
      (``layers.set_sync_group`` / ``set_width_group``; the train CLI sets
      them);
    * else the plain step for one rank (no group, or a group of one), or
      the data-parallel step (``make_train_step`` with the group), whose
      BatchNorms must sum over ``group`` exactly when ``cfg.sync_bn``.

    Returns the step tagged with ``.bn_semantics``, "sync" or "local"."""
    import torch.distributed as tdist

    from ..models.layers import sync_groups, width_groups

    if width_group is not None and tdist.get_world_size(width_group) > 1:
        if not (cfg.width_axis and cfg.sync_bn):
            raise ValueError(
                "width-sharded step: it needs cfg.width_axis set and sync "
                "BatchNorm (cfg.sync_bn; per-rank statistics over a part "
                "of a frame are not the reference's localbn)")
        if group is None or sync_groups(state.model) != {group}:
            raise ValueError(
                "width-sharded step: call layers.set_sync_group(model, "
                "the world group), the group the step reduces over, so "
                "every BatchNorm sums over the whole world (tools/train.py "
                "does this)")
        if width_groups(state.model) != {width_group}:
            raise ValueError(
                "width-sharded step: call layers.set_width_group(model, "
                "width_group) (tools/train.py does this)")
        fn = make_train_step(state, cfg, group, width_group)
        fn.bn_semantics = "sync"
        return fn
    if group is not None and tdist.get_world_size(group) == 1:
        group = None
    want = group if cfg.sync_bn else None
    if group is not None and sync_groups(state.model) != {want}:
        raise ValueError(
            "data-parallel step: call layers.set_sync_group(model, "
            f"{'group' if cfg.sync_bn else 'None'}) so the BatchNorm "
            f"statistics follow cfg.sync_bn={cfg.sync_bn} (tools/train.py "
            f"does this)")
    fn = make_train_step(state, cfg, group)
    fn.bn_semantics = "sync" if cfg.sync_bn else "local"
    return fn


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
    """numpy (or tensor) batch -> tensors on ``device``. To a CUDA device
    the host arrays go through pinned memory and copy without blocking the
    host, ordered on the current stream (``data/prefetch.py:
    device_prefetch`` makes that a side stream)."""
    if torch.device(device).type != "cuda":
        return {k: torch.as_tensor(v, device=device)
                for k, v in batch.items()}
    return {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}
