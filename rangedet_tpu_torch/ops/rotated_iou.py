"""Rotated (BEV) IoU between convex quads, counterpart of
``rangedet_tpu/ops/rotated_iou.py:iou_bev_corners`` (reference CUDA op
RotatedIOU, rotated_iou-inl.h:477-493).

The intersection is the Green's-theorem clip of ``quad_intersection_area``:
the parts of A's edges inside B plus the parts of B's edges inside A, each
found by Liang-Barsky clipping against the other quad's four half-planes.
It needs no vertex sort, so it has no one-hot lookups to get wrong.
"""
from __future__ import annotations

import torch

from .boxes import polygon_area

EPS = 1e-8

_REVERSE = [0, 3, 2, 1]


def _ccw(p: torch.Tensor) -> torch.Tensor:
    return torch.where((polygon_area(p) < 0)[..., None, None],
                       p[..., _REVERSE, :], p)


def _pieces(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Sum of cross(q0, q1) over the parts of P's edges inside Q."""
    p0 = P  # (..., 4, 2)
    p1 = torch.roll(P, -1, dims=-2)
    q0 = Q
    e = torch.roll(Q, -1, dims=-2) - Q  # CCW edge vectors

    # f[..., i, j] = cross(e_j, P_i - Q_j): >= 0 <=> vertex i inside
    # half-plane j
    rel_x = p0[..., :, None, 0] - q0[..., None, :, 0]
    rel_y = p0[..., :, None, 1] - q0[..., None, :, 1]
    f0 = e[..., None, :, 0] * rel_y - e[..., None, :, 1] * rel_x
    rel1_x = p1[..., :, None, 0] - q0[..., None, :, 0]
    rel1_y = p1[..., :, None, 1] - q0[..., None, :, 1]
    f1 = e[..., None, :, 0] * rel1_y - e[..., None, :, 1] * rel1_x

    denom = f0 - f1
    t_star = f0 / torch.where(denom.abs() > EPS, denom, torch.ones_like(denom))
    entering = (f0 < 0) & (f1 >= 0)
    exiting = (f0 >= 0) & (f1 < 0)
    outside = (f0 < 0) & (f1 < 0)

    zero, one = torch.zeros_like(t_star), torch.ones_like(t_star)
    t0 = torch.where(entering, t_star, zero).amax(dim=-1)  # (..., 4)
    t1 = torch.where(exiting, t_star, one).amin(dim=-1)
    empty = outside.any(dim=-1) | (t1 <= t0)

    d = p1 - p0
    s0 = p0 + t0[..., None] * d
    s1 = p0 + t1[..., None] * d
    contrib = s0[..., 0] * s1[..., 1] - s0[..., 1] * s1[..., 0]
    return torch.where(empty, torch.zeros_like(contrib), contrib).sum(dim=-1)


def quad_intersection_area(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection area of convex quads: (..., 4, 2) x (..., 4, 2) -> (...).
    Exactly coincident quads return area(A)."""
    a, b = torch.broadcast_tensors(a.float(), b.float())
    a = _ccw(a)
    b = _ccw(b)
    area = torch.clamp(_pieces(a, b) + _pieces(b, a), min=0.0) / 2.0
    same = (a - b).abs().reshape(a.shape[:-2] + (8,)).amax(dim=-1) < 1e-6
    return torch.where(same, polygon_area(a).abs(), area)


def iou_bev_corners(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """BEV IoU of quads given as corners: (..., 4, 2), (..., 4, 2) -> (...);
    0 when either quad is (near-)degenerate."""
    sa = polygon_area(a.float()).abs()
    sb = polygon_area(b.float()).abs()
    inter = quad_intersection_area(a, b)
    iou = inter / torch.clamp(sa + sb - inter, min=EPS)
    return torch.where((sa < EPS) | (sb < EPS), torch.zeros_like(iou), iou)


def max_iou_vs_gt(proposals_corners: torch.Tensor, gt_corners: torch.Tensor,
                  topk_gt: int = 0) -> torch.Tensor:
    """Max BEV IoU of each proposal (N, 4, 2) against a GT set (M, 4, 2) ->
    (N,) in [0, 1], NaN/Inf/out-of-range IoUs cleaned to 0 (reference
    operator_py/batch_rotated_iou.py:31-49). With 0 < topk_gt < M only the
    topk_gt GTs nearest by BEV center distance are clipped, as
    ``rangedet_tpu/ops/rotated_iou.py:max_iou_vs_gt`` does (the JAX chunking
    only bounds TPU memory and is left out)."""
    if topk_gt and topk_gt < gt_corners.shape[0]:
        pc = proposals_corners.mean(dim=-2)
        gc = gt_corners.mean(dim=-2)
        d2 = ((pc[:, None, :] - gc[None, :, :]) ** 2).sum(-1)
        idx = torch.topk(-d2, topk_gt, dim=-1).indices  # (N, K)
        iou = iou_bev_corners(proposals_corners[:, None], gt_corners[idx])
    else:
        iou = iou_bev_corners(proposals_corners[:, None], gt_corners[None])
    iou = torch.where(torch.isfinite(iou), iou, torch.zeros_like(iou))
    iou = torch.where((iou < 0) | (iou > 1), torch.zeros_like(iou), iou)
    return iou.amax(dim=-1)
