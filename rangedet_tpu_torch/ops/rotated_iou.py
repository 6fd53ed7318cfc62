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


def iou_bev_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs BEV IoU: a (N, 4, 2), b (M, 4, 2) -> (N, M), the reference's
    ``mx.nd.contrib.RotatedIOU`` in 8-point mode."""
    return iou_bev_corners(a[:, None], b[None, :])


def iou_3d_csa(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D IoU of csa7 boxes (..., 7), broadcast -> (...): BEV overlap times
    z overlap (iou_3d, rotated_iou-inl.h:495-507, with the footprint's
    length along the heading, as ``rangedet_tpu/ops/rotated_iou.py:
    iou_3d_csa``)."""
    from .boxes import csa_to_corners_bev

    a, b = a.float(), b.float()
    sa = a[..., 3] * a[..., 4] * a[..., 5]
    sb = b[..., 3] * b[..., 4] * b[..., 5]
    s_overlap = quad_intersection_area(csa_to_corners_bev(a),
                                       csa_to_corners_bev(b))
    h_overlap = torch.clamp(
        torch.minimum(a[..., 2] + a[..., 5] / 2, b[..., 2] + b[..., 5] / 2)
        - torch.maximum(a[..., 2] - a[..., 5] / 2, b[..., 2] - b[..., 5] / 2),
        min=0.0)
    inter = s_overlap * h_overlap
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


# ------------------------------------------------ the evaluator's variant
def _pseudo_angle(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Monotone surrogate for atan2(dy, dx): maps the angle to [0, 4)."""
    t = dx / torch.clamp(dx.abs() + dy.abs(), min=EPS)
    return torch.where(dy >= 0, 1.0 - t, 3.0 + t)


def _quad_intersection_area_candidates(a: torch.Tensor, b: torch.Tensor
                                       ) -> torch.Tensor:
    """The candidate-vertex formulation (``rangedet_tpu/ops/rotated_iou.py:
    _quad_intersection_area_candidates``, the reference's algorithm): the
    16 edge-pair intersections and the corners of each quad inside the
    other (boundary-inclusive, relative tolerance), ordered by pseudo-angle
    around their centroid (stable, ties by index), fan area."""
    a, b = torch.broadcast_tensors(a.float(), b.float())
    a1, b1 = torch.roll(a, -1, dims=-2), torch.roll(b, -1, dims=-2)
    p0x, p0y = a[..., :, None, 0], a[..., :, None, 1]
    p1x, p1y = a1[..., :, None, 0], a1[..., :, None, 1]
    q0x, q0y = b[..., None, :, 0], b[..., None, :, 1]
    q1x, q1y = b1[..., None, :, 0], b1[..., None, :, 1]
    A1, B1 = p1y - p0y, p0x - p1x
    C1 = A1 * p0x + B1 * p0y
    A2, B2 = q1y - q0y, q0x - q1x
    C2 = A2 * q0x + B2 * q0y
    det = A1 * B2 - A2 * B1
    nondeg = det.abs() > EPS
    safe = torch.where(nondeg, det, torch.ones_like(det))
    ix = (B2 * C1 - B1 * C2) / safe
    iy = (A1 * C2 - A2 * C1) / safe

    def on_segment(x, y, sx0, sy0, sx1, sy1):
        return ((torch.minimum(sx0, sx1) <= x + EPS)
                & (torch.maximum(sx0, sx1) >= x - EPS)
                & (torch.minimum(sy0, sy1) <= y + EPS)
                & (torch.maximum(sy0, sy1) >= y - EPS))

    inter_valid = (nondeg & on_segment(ix, iy, p0x, p0y, p1x, p1y)
                   & on_segment(ix, iy, q0x, q0y, q1x, q1y))
    batch = ix.shape[:-2]
    inter = torch.stack([ix, iy], dim=-1).reshape(batch + (16, 2))
    inter_valid = inter_valid.reshape(batch + (16,))

    def corners_inside(quad, pts):
        c0 = quad[..., None, :, :]
        c1 = torch.roll(quad, -1, dims=-2)[..., None, :, :]
        ex, ey = c1[..., 0] - c0[..., 0], c1[..., 1] - c0[..., 1]
        rx = pts[..., :, None, 0] - c0[..., 0]
        ry = pts[..., :, None, 1] - c0[..., 1]
        pos = ex * ry - ey * rx
        tol = 1e-5 * torch.sqrt((ex * ex + ey * ey) * (rx * rx + ry * ry)) + EPS
        return ~((pos > tol).any(dim=-1) & (pos < -tol).any(dim=-1))

    pts = torch.cat([inter, b, a], dim=-2)  # (..., 24, 2)
    valid = torch.cat([inter_valid, corners_inside(a, b),
                       corners_inside(b, a)], dim=-1)
    cnt = valid.sum(dim=-1)
    wsum = torch.where(valid[..., None], pts, torch.zeros_like(pts)).sum(-2)
    center = wsum / torch.clamp(cnt, min=1)[..., None]
    q = pts - center[..., None, :]
    keys = torch.where(valid, _pseudo_angle(q[..., 0], q[..., 1]),
                       torch.full_like(q[..., 0], float("inf")))
    order = torch.argsort(keys, dim=-1, stable=True)
    qs = torch.gather(q, -2, order[..., None].expand(q.shape))
    vs = torch.gather(valid, -1, order)
    # the valid vertices come first, in angular order; each one's successor
    # is the next, the last one's the first
    n = q.shape[-2]
    idx = torch.arange(n, device=q.device)
    nxt = torch.where(idx[None] + 1 < cnt[..., None], idx + 1,
                      torch.zeros_like(idx)).reshape(batch + (n,))
    qn = torch.gather(qs, -2, nxt[..., None].expand(qs.shape))
    tri = qs[..., 0] * qn[..., 1] - qs[..., 1] * qn[..., 0]
    return torch.where(vs, tri, torch.zeros_like(tri)).sum(dim=-1).abs() / 2.0


def iou_bev_matrix_robust(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs BEV IoU via the candidate-vertex formulation: a (N, 4, 2),
    b (M, 4, 2) -> (N, M) in [0, 1]; for the host-side evaluator
    (``eval/ap.py``), as ``rangedet_tpu/ops/rotated_iou.py:
    iou_bev_matrix_robust``."""
    inter = _quad_intersection_area_candidates(a[:, None], b[None, :])
    sa = polygon_area(a.float()).abs()[:, None]
    sb = polygon_area(b.float()).abs()[None, :]
    iou = torch.clamp(inter / torch.clamp(sa + sb - inter, min=EPS), 0.0, 1.0)
    return torch.where((sa < EPS) | (sb < EPS), torch.zeros_like(iou), iou)


def iou_3d_csa_robust(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D IoU of csa7 boxes (..., 7), broadcast -> (...), with the BEV
    overlap of the candidate-vertex formulation (``rangedet_tpu/ops/
    rotated_iou.py:iou_3d_csa_robust``)."""
    from .boxes import csa_to_corners_bev

    a, b = a.float(), b.float()
    ca, cb = csa_to_corners_bev(a), csa_to_corners_bev(b)
    sa = a[..., 3] * a[..., 4] * a[..., 5]
    sb = b[..., 3] * b[..., 4] * b[..., 5]
    s_overlap = torch.minimum(
        _quad_intersection_area_candidates(ca, cb),
        torch.minimum(polygon_area(ca).abs(), polygon_area(cb).abs()))
    h_overlap = torch.clamp(
        torch.minimum(a[..., 2] + a[..., 5] / 2, b[..., 2] + b[..., 5] / 2)
        - torch.maximum(a[..., 2] - a[..., 5] / 2, b[..., 2] - b[..., 5] / 2),
        min=0.0)
    inter = s_overlap * h_overlap
    iou = torch.clamp(inter / torch.clamp(sa + sb - inter, min=EPS), 0.0, 1.0)
    return torch.where((sa < EPS) | (sb < EPS), torch.zeros_like(iou), iou)
