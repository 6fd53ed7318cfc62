"""Named ranges of the program's steps for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records, and a shared null context otherwise: a
``record_function`` does its bookkeeping even with no profiler on (about
9 us a range on a CPU host, more than one aten op), and the eval step
opens about two ranges a round of its weighted NMS. Behind the check a
closed span costs one attribute read.

The ranges sit on the profiler's own clock beside the device trace, so a
reader ties each kernel to the innermost range open at its launch by
CUPTI's correlation id (``tools/profile_eval.py:range_device_ms``,
``portbench/trace.py``). Keep names off the prefixes those readers take
for the profiler's own events: ``cu``, ``aten::``, ``autograd::``,
``torch::``, ``Optimizer.``, ``Memcpy`` and ``Memset``.

The ranges, by where they open:

* ``infer.make_eval_step``: ``forward``, ``postprocess``;
* ``models/detector.py:run_inference``: ``topk`` (the scores' sigmoid
  and level concat, then per class the mask, the stable sort and the
  gathers), ``decode`` and ``wnms`` (the weighted NMS and the eval rows),
  per class;
* ``ops/nms.py:weighted_nms``: ``wnms.round`` around each pass of the loop
  that does work, ``host_sync`` around each wait for the card: the loop's
  check (its rounds plus one a call) and, inside a round, the two list
  indexes of ``ops/rotated_iou.py:_ccw``;
* ``train/train_step.py``: ``train_step`` around the stages ``targets``,
  ``forward``, ``losses``, ``backward`` (``all_reduce`` with a process
  group) and ``optimizer``;
* ``models/dla_backbone.py``: ``meta_block``; ``ops/iou_target.py``:
  ``iou_target``; ``tools/train.py``: ``device_cache_batch``.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared context that does nothing."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL
