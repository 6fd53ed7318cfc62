"""Dense per-pixel target generation, counterpart of
``rangedet_tpu/ops/targets.py`` (reference host stages GenerateTarget and
GenerateFPNTarget, rangedet/core/input.py:323-607, util_func.py:10-53), on
the device inside the train step.

Regression target (8 dims, observation/azimuth frame, input.py:452-506):

  [ sqrt-signed dx, sqrt-signed dy, log w, log l, cos dyaw, sin dyaw,
    bottom-z, log h ]

where dx, dy are the box-center offsets rotated into the pixel's azimuth
frame and dyaw = yaw - azimuth.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..parallel.dist import all_reduce_sum
from .assigner import points_per_box


def _label_mapping(label_set: Sequence[int], device) -> torch.Tensor:
    """Waymo type enum (<= 4; margin to 8) -> class index in label_set."""
    mapping = torch.zeros(8, dtype=torch.int32, device=device)
    for i, label in enumerate(label_set):
        mapping[label] = i
    return mapping


def reg_targets(points: torch.Tensor, gt_csa: torch.Tensor,
                assignment: torch.Tensor) -> torch.Tensor:
    """points (N, 3), gt_csa (M, 7), assignment (N,) (-1 = background)
    -> (N, 8) targets, zero rows for unassigned points."""
    box = gt_csa.float()[assignment.clamp(min=0).long()]
    return _reg_targets_from_box(points.float(), box, assignment >= 0)


def _reg_targets_from_box(points: torch.Tensor, box: torch.Tensor,
                          assigned: torch.Tensor) -> torch.Tensor:
    """reg_targets with the per-point box rows already looked up."""
    azimuth = torch.atan2(points[:, 1], points[:, 0])
    delta_yaw = box[:, 6] - azimuth
    dx = box[:, 0] - points[:, 0]
    dy = box[:, 1] - points[:, 1]
    cos_a, sin_a = torch.cos(azimuth), torch.sin(azimuth)
    dx_obs = cos_a * dx + sin_a * dy
    dy_obs = -sin_a * dx + cos_a * dy
    dx_obs = torch.sqrt(dx_obs.abs()) * torch.sign(dx_obs)
    dy_obs = torch.sqrt(dy_obs.abs()) * torch.sign(dy_obs)

    def safe_log(v):
        return torch.log(v.clamp(min=1e-6))

    target = torch.stack([
        dx_obs, dy_obs, safe_log(box[:, 4]), safe_log(box[:, 3]),
        torch.cos(delta_yaw), torch.sin(delta_yaw),
        box[:, 2] - box[:, 5] / 2.0, safe_log(box[:, 5]),
    ], dim=1)
    return torch.where(assigned[:, None], target, torch.zeros_like(target))


def reg_weights(assignment: torch.Tensor, reg_dim_weights: Sequence[float]
                ) -> torch.Tensor:
    """(N,) assignment -> (N, 8) per-dim loss weights, 0 for background
    (input.py:440-450)."""
    w = torch.tensor(reg_dim_weights, dtype=torch.float32,
                     device=assignment.device)
    return torch.where((assignment >= 0)[:, None], w[None, :],
                       torch.zeros_like(w)[None, :])


def cls_targets(gt_class: torch.Tensor, assignment: torch.Tensor,
                label_set: Sequence[int]) -> torch.Tensor:
    """Per-point class index in [0, K]; K = len(label_set) is background
    (input.py:417-429)."""
    mapping = _label_mapping(label_set, assignment.device)
    gt_mapped = mapping[gt_class.long().clamp(0, 7)]
    per_point = gt_mapped[assignment.clamp(min=0).long()]
    return torch.where(assignment >= 0, per_point,
                       torch.full_like(per_point, len(label_set)))


def class_aware_expand(data: torch.Tensor, cls_target: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    """(N, C) rows into their class slot -> (N, K*C) (util_func.py:41-53);
    identity for K == 1."""
    if num_classes == 1:
        return data
    classes = torch.arange(num_classes, device=data.device)
    onehot = (cls_target.long()[:, None] == classes[None, :]).to(data.dtype)
    return (onehot[:, :, None] * data[:, None, :]).reshape(
        data.shape[0], num_classes * data.shape[1])


def interval_masks(
    unnormalized_range: torch.Tensor,
    intervals: Dict[int, tuple],
    strides: Sequence[int],
) -> Dict[int, torch.Tensor]:
    """{stride: float mask} keeping pixels with lower <= range < upper
    (input.py:587-597)."""
    out = {}
    for s in strides:
        lo, hi = intervals[s]
        out[s] = ((unnormalized_range >= lo) & (unnormalized_range < hi)).float()
    return out


def stride_slice(data: torch.Tensor, stride: int, w_axis: int = 1
                 ) -> torch.Tensor:
    """Width subsampling with the reference's phase: begin = stride // 2
    (util_func.py:10-25)."""
    if stride == 1:
        return data
    index = [slice(None)] * data.dim()
    index[w_axis] = slice(stride // 2, None, stride)
    return data[tuple(index)]


def generate_dense_targets(
    points_hw3: torch.Tensor,
    gt_csa: torch.Tensor,
    gt_class: torch.Tensor,
    assignment: torch.Tensor,
    label_set: Sequence[int],
    reg_dim_weights: Sequence[float],
    count_group=None,
) -> Dict[str, torch.Tensor]:
    """Full-resolution dense targets of one frame, channels last (H, W, C):
    reg targets, per-dim weights, 1/N normalization weights and the
    class-aware expansion (input.py:346-393).

    ``count_group``: the width group of a width-sharded frame (JAX's
    ``count_sync_axis``, ``rangedet_tpu/ops/targets.py:170-203``); the
    per-box point counts, the 1/N weights' denominators, are summed over
    it, so a box that spans a shard's edge is normalized by its global
    count.

    The per-box lookups (box row, class id, points in the box) are index
    gathers. The JAX package runs them as one one-hot matmul at
    Precision.HIGHEST, a TPU workaround; both give the same values."""
    H, W = points_hw3.shape[:2]
    N = H * W
    pts = points_hw3.reshape(N, 3).float()
    K = len(label_set)
    M = gt_csa.shape[0]

    assigned = assignment >= 0
    idx = assignment.clamp(min=0).long()
    counts = points_per_box(assignment, M)
    if count_group is not None:
        counts = all_reduce_sum(counts, count_group)
    gt_mapped = _label_mapping(label_set, pts.device)[
        gt_class.long().clamp(0, 7)]

    tgt = _reg_targets_from_box(pts, gt_csa.float()[idx], assigned)
    norm_w = torch.where(assigned, 1.0 / counts[idx].clamp(min=1.0),
                         torch.zeros(N, device=pts.device))
    norm_w = norm_w[:, None].expand(N, len(reg_dim_weights))
    dim_w = reg_weights(assignment, reg_dim_weights)
    cls_t = torch.where(assigned, gt_mapped[idx],
                        torch.full_like(gt_mapped[idx], K))

    tgt = class_aware_expand(tgt, cls_t, K)
    norm_w = class_aware_expand(norm_w, cls_t, K)
    dim_w = class_aware_expand(dim_w, cls_t, K)
    if K == 1:
        onehot = (cls_t[:, None] == 0).float()
    else:
        onehot = class_aware_expand(torch.ones(N, 1, device=pts.device),
                                    cls_t, K)
    C = K * len(reg_dim_weights)
    return {
        "rpn_reg_target": tgt.reshape(H, W, C),
        "reg_normalize_weight": norm_w.reshape(H, W, C),
        "rpn_reg_weight": dim_w.reshape(H, W, C),
        "rpn_cls_target": onehot.reshape(H, W, K),
    }
