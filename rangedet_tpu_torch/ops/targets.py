"""The serving path's part of ``rangedet_tpu/ops/targets.py``: the
range-conditioned pyramid masks and the width stride slice
(reference GenerateFPNTarget, input.py:587-607)."""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def interval_masks(
    unnormalized_range: torch.Tensor,
    intervals: Dict[int, tuple],
    strides: Sequence[int],
) -> Dict[int, torch.Tensor]:
    """{stride: float mask} keeping pixels with lower <= range < upper."""
    out = {}
    for s in strides:
        lo, hi = intervals[s]
        out[s] = ((unnormalized_range >= lo) & (unnormalized_range < hi)).float()
    return out


def stride_slice(data: torch.Tensor, stride: int, w_axis: int = 1
                 ) -> torch.Tensor:
    """Width subsampling with the reference's phase: begin = stride // 2."""
    if stride == 1:
        return data
    index = [slice(None)] * data.dim()
    index[w_axis] = slice(stride // 2, None, stride)
    return data[tuple(index)]
