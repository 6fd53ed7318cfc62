"""The reduction of the data-parallel train step, counterpart of
``rangedet_tpu/parallel/shard_map_step.py``: each rank runs the kernels on
its own rows of the global batch (``train_step.make_train_step`` with a
group), then the ranks' gradients are reduced before the update, as
Horovod's allreduce does in the reference (tools/train.py:67-79).

BatchNorm follows the model's sync group (``layers.set_sync_group``):

* sync (``cfg.sync_bn``): every BatchNorm sums its statistics over the
  group, the losses their normalizers (``losses.py``); each rank's loss
  and gradient are partials of the global batch's, so gradients and
  metrics are summed;
* local (``sync_bn=False``, the reference's "localbn"): each rank's own
  statistics and normalizers; gradients and metrics are averaged.

Either way the running statistics are averaged every step
(``shard_map_step.py:14-17``; in sync mode they are equal on every rank
already). The reduction comes before ``apply_update``, so the clip, the
optimizer and AdamWS see the reduced gradient, as optax does after the
psum. The gradients are reduced after the backward in flat buffers
(``dist.all_reduce_``), not by ``DistributedDataParallel``, which averages
where sync mode sums and broadcasts rank 0's buffers where localbn
averages them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.layers import BatchNormFold, sync_groups
from .dist import all_reduce_

Metrics = Dict[str, torch.Tensor]


def make_reduction(model: torch.nn.Module, group
                   ) -> Tuple[Optional[object], Callable[[Metrics], Metrics]]:
    """-> (sync, reduce_grads_and_stats): the group the model's BatchNorms
    sum over (None: local), and the step's reduction over ``group``, which
    sums (sync) or averages (local) the parameters' gradients and the
    metrics in place of each rank's, averages the running statistics, and
    returns the reduced metrics."""
    groups = sync_groups(model)
    if len(groups) != 1:
        raise ValueError("the model's BatchNorms sum over different groups")
    (sync,) = groups
    stats = [t for m in model.modules() if isinstance(m, BatchNormFold)
             for t in (m.running_mean, m.running_var)]
    mean = sync is None

    def reduce_grads_and_stats(metrics: Metrics) -> Metrics:
        keys = sorted(metrics)
        values = torch.stack([metrics[k].detach() for k in keys])
        all_reduce_([p.grad for p in model.parameters()
                     if p.grad is not None] + [values], group, mean)
        with torch.no_grad():
            all_reduce_(stats, group, mean=True)
        return dict(zip(keys, values.unbind()))

    return sync, reduce_grads_and_stats
