"""Per-point 3D box decode, counterpart of ``rangedet_tpu/ops/decode.py``
(reference CUDA op Decode3DBbox, decode_3d_bbox-inl.h:169-277).

A delta is [dx, dy, log_width, log_length, cos_yaw, sin_yaw, z0,
log_height] in the point's azimuth frame; dx, dy are signed-sqrt
compressed. The decode rotates it back into the vehicle frame and emits
box10 [4 BEV corners (A, B, C, D), z0, z1].
"""
from __future__ import annotations

import torch


def decode_boxes(deltas: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(..., 8) deltas, (..., 3) points -> (..., 10) box10, in f32."""
    deltas = deltas.float()
    points = points.float()

    pc_x, pc_y = points[..., 0], points[..., 1]
    azimuth = torch.atan2(pc_y, pc_x)
    cos_azi, sin_azi = torch.cos(azimuth), torch.sin(azimuth)

    dx, dy = deltas[..., 0], deltas[..., 1]
    width = torch.exp(deltas[..., 2])
    length = torch.exp(deltas[..., 3])
    cos_yaw, sin_yaw = deltas[..., 4], deltas[..., 5]
    z0 = deltas[..., 6]
    height = torch.exp(deltas[..., 7])

    # un-square the signed-sqrt compression
    dx = dx * torch.abs(dx)
    dy = dy * torch.abs(dy)

    cx = pc_x + (dx * cos_azi - dy * sin_azi)
    cy = pc_y + (dx * sin_azi + dy * cos_azi)

    yaw = torch.atan2(sin_yaw, cos_yaw) + azimuth
    sin_y, cos_y = torch.sin(yaw), torch.cos(yaw)

    # box-frame corners A(+l,-w) B(-l,-w) C(-l,+w) D(+l,+w) (x1/2)
    half_l, half_w = 0.5 * length, 0.5 * width
    lx = torch.stack([half_l, -half_l, -half_l, half_l], dim=-1)
    wy = torch.stack([-half_w, -half_w, half_w, half_w], dim=-1)
    x = lx * cos_y[..., None] - wy * sin_y[..., None] + cx[..., None]
    y = lx * sin_y[..., None] + wy * cos_y[..., None] + cy[..., None]

    corners = torch.stack([x, y], dim=-1).reshape(deltas.shape[:-1] + (8,))
    return torch.cat([corners, z0[..., None], (z0 + height)[..., None]], -1)
