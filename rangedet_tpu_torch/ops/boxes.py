"""Box format conversions on tensors, counterpart of
``rangedet_tpu/ops/boxes.py`` (formats documented there):

  csa7       [cx, cy, cz, length, width, height, yaw]
  box10      [x1,y1, x2,y2, x3,y3, x4,y4, z0, z1]
  box11      [x1..y4 (8), yaw, z0(bottom), height]
  box12      box11 + [score]
  box8_eval  [cx, cy, cz, length, width, height, heading, score]
  corners4   (..., 4, 2) BEV corners A(+l,-w) B(-l,-w) C(-l,+w) D(+l,+w) /2
  corners8   (..., 8, 3) 3D corners, bottom 4 then top 4
"""
from __future__ import annotations

import torch

_CORNER_SIGNS = ((0.5, -0.5), (-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5))


def csa_to_corners_bev(csa: torch.Tensor) -> torch.Tensor:
    """csa7 (..., 7) -> BEV corners (..., 4, 2)."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=csa.dtype, device=csa.device)
    lx = signs[:, 0] * csa[..., 3:4]  # (..., 4)
    wy = signs[:, 1] * csa[..., 4:5]
    cos, sin = torch.cos(csa[..., 6:7]), torch.sin(csa[..., 6:7])
    x = lx * cos - wy * sin + csa[..., 0:1]
    y = lx * sin + wy * cos + csa[..., 1:2]
    return torch.stack([x, y], dim=-1)


def csa_to_corners3d(csa: torch.Tensor) -> torch.Tensor:
    """csa7 (..., 7) -> 3D corners (..., 8, 3), bottom 4 then top 4."""
    bev = csa_to_corners_bev(csa)
    cz, h = csa[..., 2], csa[..., 5]
    z_bot = (cz - 0.5 * h)[..., None, None].expand(bev[..., :1].shape)
    z_top = (cz + 0.5 * h)[..., None, None].expand(bev[..., :1].shape)
    return torch.cat([torch.cat([bev, z_bot], -1),
                      torch.cat([bev, z_top], -1)], dim=-2)


def box10_to_corners_bev(box10: torch.Tensor) -> torch.Tensor:
    """box10 (..., 10) -> BEV corners (..., 4, 2)."""
    return box10[..., :8].reshape(box10.shape[:-1] + (4, 2))


def box10_to_box11(box10: torch.Tensor) -> torch.Tensor:
    """box10 -> box11 (reference tools/test.py:56 bbox3d_10dim_to_11dim):
    yaw = atan2(y1 - y2, x1 - x2), the first edge's direction."""
    c = box10[..., :8]
    z0 = box10[..., 8:9]
    z1 = box10[..., 9:10]
    yaw = torch.atan2(c[..., 1] - c[..., 3], c[..., 0] - c[..., 2])[..., None]
    return torch.cat([c, yaw, z0, z1 - z0], dim=-1)


def box12_to_box8_eval(box12: torch.Tensor) -> torch.Tensor:
    """box12 -> [cx, cy, cz, length, width, height, heading, score]
    (reference tools/test.py:43 bbox3d_12dim_to_8dim)."""
    cx = box12[..., 0:8:2].mean(dim=-1)
    cy = box12[..., 1:8:2].mean(dim=-1)
    z0 = box12[..., 9]
    height = box12[..., 10]
    cz = z0 + height / 2.0
    length = torch.sqrt(
        (box12[..., 2] - box12[..., 0]) ** 2
        + (box12[..., 3] - box12[..., 1]) ** 2
    )
    width = torch.sqrt(
        (box12[..., 2] - box12[..., 4]) ** 2
        + (box12[..., 3] - box12[..., 5]) ** 2
    )
    return torch.stack(
        [cx, cy, cz, length, width, height, box12[..., 8], box12[..., 11]],
        dim=-1,
    )


def box10_to_csa7(box10: torch.Tensor) -> torch.Tensor:
    """box10 -> csa7 (reference operator_py/batch_rotated_iou.py:51-68
    to_box_type_7): L = |corner0 - corner1| (the length edge), W = |corner1
    - corner2|, yaw along corner1 -> corner0."""
    pts = box10_to_corners_bev(box10)  # (..., 4, 2)
    center_xy = pts.mean(dim=-2)
    center_z = box10[..., 8:10].mean(dim=-1, keepdim=True)
    length = torch.linalg.vector_norm(pts[..., 0, :] - pts[..., 1, :],
                                      dim=-1, keepdim=True)
    width = torch.linalg.vector_norm(pts[..., 1, :] - pts[..., 2, :],
                                     dim=-1, keepdim=True)
    height = box10[..., 9:10] - box10[..., 8:9]
    yaw = torch.atan2(pts[..., 0, 1] - pts[..., 1, 1],
                      pts[..., 0, 0] - pts[..., 1, 0])[..., None]
    return torch.cat([center_xy, center_z, length, width, height, yaw],
                     dim=-1)


def polygon_area(corners: torch.Tensor) -> torch.Tensor:
    """Signed shoelace area of a polygon (..., K, 2); CCW positive."""
    x, y = corners[..., 0], corners[..., 1]
    x2 = torch.roll(x, -1, dims=-1)
    y2 = torch.roll(y, -1, dims=-1)
    return 0.5 * torch.sum(x * y2 - x2 * y, dim=-1)


def canonicalize_ccw(corners: torch.Tensor) -> torch.Tensor:
    """Quad corners (..., 4, 2) reordered counter-clockwise where needed."""
    area = polygon_area(corners)
    return torch.where((area < 0)[..., None, None],
                       corners[..., [0, 3, 2, 1], :], corners)
