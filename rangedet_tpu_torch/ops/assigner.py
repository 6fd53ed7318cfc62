"""Point-to-box assignment, counterpart of ``rangedet_tpu/ops/assigner.py``
(reference host lib ``processing_cxx.assign3D_v2`` / ``get_point_num``,
operator_cxx/src_cxx/assigner.h:11-109), as a dense (N points x M boxes)
test on the device.

The reference's semantics, thresholds included:
  * a point must be valid (range mask) and not in a no-label zone;
  * it must lie inside the global extent of the valid GT boxes;
  * its squared distance to the nearest box center must be <= max_dist_sq;
  * per box: squared center distance <= radius_sq, bottom < z < top
    (strict), and the 4 BEV edge dot-products strictly > 0;
  * the first (lowest-index) matching box wins.
"""
from __future__ import annotations

from typing import Optional

import torch

DEFAULT_RADIUS_SQ = 100.0
DEFAULT_MAX_DIST_SQ = 20.0


def assign_points_to_boxes(
    points: torch.Tensor,
    corners8: torch.Tensor,
    point_mask: torch.Tensor,
    box_valid: Optional[torch.Tensor] = None,
    is_in_nlz: Optional[torch.Tensor] = None,
    radius_sq: float = DEFAULT_RADIUS_SQ,
    max_dist_sq: float = DEFAULT_MAX_DIST_SQ,
) -> torch.Tensor:
    """points (N, 3), corners8 (M, 8, 3), point_mask (N,), box_valid (M,),
    is_in_nlz (N,) (> 0 excludes the point) -> (N,) int32 box index, -1
    when unassigned."""
    points = points.float()
    corners8 = corners8.float()
    A, B, C, D, E = (corners8[:, i, :] for i in range(5))
    center = corners8.mean(dim=1)  # (M, 3)
    d2 = ((points[:, None, :] - center[None, :, :]) ** 2).sum(-1)  # (N, M)
    px, py, pz = points[:, 0:1], points[:, 1:2], points[:, 2:3]

    in_z = (pz > A[None, :, 2]) & (pz < E[None, :, 2])

    def edge_dot(c_from, c_to, anchor):
        vx = (c_to[:, 0] - c_from[:, 0])[None, :]
        vy = (c_to[:, 1] - c_from[:, 1])[None, :]
        return vx * (px - anchor[None, :, 0]) + vy * (py - anchor[None, :, 1])

    in_quad = ((edge_dot(B, A, B) > 0) & (edge_dot(B, C, B) > 0)
               & (edge_dot(D, A, D) > 0) & (edge_dot(D, C, D) > 0))
    per_box = in_z & in_quad & (d2 <= radius_sq)

    if box_valid is None:
        valid = torch.ones(corners8.shape[0], dtype=torch.bool,
                           device=points.device)
    else:
        valid = box_valid.bool()
        per_box = per_box & valid[None, :]
        d2 = torch.where(valid[None, :], d2, torch.full_like(d2, float("inf")))

    def extent(v):  # (M, 8) -> (min, max) over the valid boxes
        inf = torch.full_like(v, float("inf"))
        return (torch.where(valid[:, None], v, inf).min(),
                torch.where(valid[:, None], v, -inf).max())

    (min_x, max_x), (min_y, max_y), (min_z, max_z) = (
        extent(corners8[..., k]) for k in range(3))
    point_ok = ((point_mask.reshape(-1) >= 0.5)
                & (px[:, 0] >= min_x) & (px[:, 0] <= max_x)
                & (py[:, 0] >= min_y) & (py[:, 0] <= max_y)
                & (pz[:, 0] >= min_z) & (pz[:, 0] <= max_z)
                & (d2.min(dim=1).values <= max_dist_sq))
    if is_in_nlz is not None:
        point_ok = point_ok & (is_in_nlz.reshape(-1) <= 0)

    per_box = per_box & point_ok[:, None]
    first = per_box.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(per_box.any(dim=1), first, torch.full_like(first, -1))


def points_per_box(assignment: torch.Tensor, num_boxes: int) -> torch.Tensor:
    """(N,) box index -> (num_boxes,) f32 count of assigned points."""
    valid = assignment >= 0
    idx = torch.where(valid, assignment, torch.zeros_like(assignment)).long()
    return torch.zeros(num_boxes, device=assignment.device).index_add_(
        0, idx, valid.float())


def normalization_weight(assignment: torch.Tensor, num_boxes: int
                         ) -> torch.Tensor:
    """Per-point 1 / (points in its box), 0 for unassigned points
    (reference GenerateTarget.get_normalization_weight, input.py:431-438)."""
    counts = points_per_box(assignment, num_boxes)
    per_point = counts[assignment.clamp(min=0).long()]
    w = 1.0 / per_point.clamp(min=1.0)
    return torch.where(assignment >= 0, w, torch.zeros_like(w))
