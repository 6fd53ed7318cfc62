"""Plain box geometry of RangeDet: the decode of a pixel's deltas into a
box, the box formats of the post-processing, and the BEV IoU of two
convex quads, whose intersection is Green's theorem over the parts of each
quad's edges inside the other (Liang-Barsky clipping). f32."""
from __future__ import annotations

import torch

EPS = 1e-8


def decode_boxes(deltas: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """deltas (..., 8) [signed sqrt dx, dy, log w, log l, cos, sin, bottom,
    log h] in the point's azimuth frame, points (..., 3) -> box10 (..., 10):
    the BEV corners A(+l,-w) B(-l,-w) C(-l,+w) D(+l,+w), bottom, top."""
    d, p = deltas.float(), points.float()
    az = torch.atan2(p[..., 1], p[..., 0])
    ca, sa = torch.cos(az), torch.sin(az)
    dx, dy = d[..., 0] * d[..., 0].abs(), d[..., 1] * d[..., 1].abs()
    cx = p[..., 0] + dx * ca - dy * sa
    cy = p[..., 1] + dx * sa + dy * ca
    w, l, h = torch.exp(d[..., 2]), torch.exp(d[..., 3]), torch.exp(d[..., 7])
    yaw = torch.atan2(d[..., 5], d[..., 4]) + az
    cy_, sy_ = torch.cos(yaw), torch.sin(yaw)
    lx = torch.stack([l, -l, -l, l], -1) * 0.5
    wy = torch.stack([-w, -w, w, w], -1) * 0.5
    x = lx * cy_[..., None] - wy * sy_[..., None] + cx[..., None]
    y = lx * sy_[..., None] + wy * cy_[..., None] + cy[..., None]
    corners = torch.stack([x, y], -1).flatten(-2)
    z0 = d[..., 6]
    return torch.cat([corners, z0[..., None], (z0 + h)[..., None]], -1)


def box11(box10: torch.Tensor) -> torch.Tensor:
    """-> [8 corners, yaw of the first edge, bottom, height]."""
    c = box10[..., :8]
    yaw = torch.atan2(c[..., 1] - c[..., 3], c[..., 0] - c[..., 2])
    return torch.cat([c, yaw[..., None], box10[..., 8:9],
                      box10[..., 9:10] - box10[..., 8:9]], -1)


def box8(box12: torch.Tensor) -> torch.Tensor:
    """[11 values, score] -> [cx, cy, cz, length, width, height, yaw,
    score]."""
    c = box12[..., :8]
    cx, cy = c[..., 0::2].mean(-1), c[..., 1::2].mean(-1)
    length = torch.sqrt((c[..., 2] - c[..., 0]) ** 2
                        + (c[..., 3] - c[..., 1]) ** 2)
    width = torch.sqrt((c[..., 2] - c[..., 4]) ** 2
                       + (c[..., 3] - c[..., 5]) ** 2)
    return torch.stack([cx, cy, box12[..., 9] + box12[..., 10] / 2, length,
                        width, box12[..., 10], box12[..., 8],
                        box12[..., 11]], -1)


def polygon_area(p: torch.Tensor) -> torch.Tensor:
    x, y = p[..., 0], p[..., 1]
    return 0.5 * (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y
                  ).sum(-1)


def _ccw(p: torch.Tensor) -> torch.Tensor:
    return torch.where((polygon_area(p) < 0)[..., None, None],
                       p[..., [0, 3, 2, 1], :], p)


def _inside_parts(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Sum of cross(s0, s1) over the parts of P's edges inside Q (both
    CCW, (..., 4, 2))."""
    p0, p1 = P, torch.roll(P, -1, dims=-2)
    e = torch.roll(Q, -1, dims=-2) - Q

    def side(p):
        rx = p[..., :, None, 0] - Q[..., None, :, 0]
        ry = p[..., :, None, 1] - Q[..., None, :, 1]
        return e[..., None, :, 0] * ry - e[..., None, :, 1] * rx

    f0, f1 = side(p0), side(p1)
    den = f0 - f1
    t = f0 / torch.where(den.abs() > EPS, den, torch.ones_like(den))
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    t0 = torch.where((f0 < 0) & (f1 >= 0), t, zero).amax(-1)
    t1 = torch.where((f0 >= 0) & (f1 < 0), t, one).amin(-1)
    empty = ((f0 < 0) & (f1 < 0)).any(-1) | (t1 <= t0)
    d = p1 - p0
    s0, s1 = p0 + t0[..., None] * d, p0 + t1[..., None] * d
    cross = s0[..., 0] * s1[..., 1] - s0[..., 1] * s1[..., 0]
    return torch.where(empty, torch.zeros_like(cross), cross).sum(-1)


def iou_bev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """BEV IoU of quads (..., 4, 2) x (..., 4, 2), broadcast -> (...); 0
    where either is degenerate."""
    a, b = torch.broadcast_tensors(a.float(), b.float())
    a, b = _ccw(a), _ccw(b)
    sa, sb = polygon_area(a).abs(), polygon_area(b).abs()
    inter = (_inside_parts(a, b) + _inside_parts(b, a)).clamp(min=0.0) / 2
    same = (a - b).abs().flatten(-2).amax(-1) < 1e-6
    inter = torch.where(same, sa, inter)
    iou = inter / torch.clamp(sa + sb - inter, min=EPS)
    return torch.where((sa < EPS) | (sb < EPS), torch.zeros_like(iou), iou)
