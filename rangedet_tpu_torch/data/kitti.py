"""KITTI range images, calibration and boxes, the port's counterpart of
``rangedet_tpu/data/kitti.py`` (the reference's offline KITTI path,
datasets/create_range_image_in_kitti.py and kitti_utils/
calibration_kitti.py):

  * the 64 x 2048 range image of a velodyne scan (nearest-inclination row,
    azimuth column, the nearest point wins each pixel) and the points-in-box
    counts, as torch on an explicit device, the card unless the caller asks
    for the CPU;
  * the HDL-64E per-laser mount heights and zenith angles (sensor constants
    the reference measured by a Hough transform: data, not code);
  * KITTI calib parsing and the camera-frame -> lidar-frame box conversion,
    numpy on the host (a file and a few boxes a frame).

The range image's winner at a pixel is the point of least range, found by a
``scatter_reduce`` (CUDA's ``index_put_`` has no defined winner among
repeated indices); among points of exactly equal range the last one of the
scan wins, as a stable far-to-near sort with last-writer-wins gives. The
JAX builder sorts with numpy's default (unstable) argsort there.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .waymo_builder import checked_device

# HDL-64E per-laser mount heights and zenith angles (Hough-fitted sensor
# constants; reference create_range_image_in_kitti.py:211-240)
KITTI_LASER_HEIGHT = np.array([
    0.20966667, 0.2092, 0.2078, 0.2078, 0.2078,
    0.20733333, 0.20593333, 0.20546667, 0.20593333, 0.20546667,
    0.20453333, 0.205, 0.2036, 0.20406667, 0.2036,
    0.20313333, 0.20266667, 0.20266667, 0.20173333, 0.2008,
    0.2008, 0.2008, 0.20033333, 0.1994, 0.20033333,
    0.19986667, 0.1994, 0.1994, 0.19893333, 0.19846667,
    0.19846667, 0.19846667, 0.12566667, 0.1252, 0.1252,
    0.12473333, 0.12473333, 0.1238, 0.12333333, 0.1238,
    0.12286667, 0.1224, 0.12286667, 0.12146667, 0.12146667,
    0.121, 0.12053333, 0.12053333, 0.12053333, 0.12006667,
    0.12006667, 0.1196, 0.11913333, 0.11866667, 0.1182,
    0.1182, 0.1182, 0.11773333, 0.11726667, 0.11726667,
    0.1168, 0.11633333, 0.11633333, 0.1154,
], dtype=np.float32)

KITTI_LASER_ZENITH = np.array([
    0.03373091, 0.02740409, 0.02276443, 0.01517224, 0.01004049,
    0.00308099, -0.00155868, -0.00788549, -0.01407172, -0.02103122,
    -0.02609267, -0.032068, -0.03853542, -0.04451074, -0.05020488,
    -0.0565317, -0.06180405, -0.06876355, -0.07361411, -0.08008152,
    -0.08577566, -0.09168069, -0.09793721, -0.10398284, -0.11052055,
    -0.11656618, -0.12219002, -0.12725147, -0.13407038, -0.14067839,
    -0.14510716, -0.15213696, -0.1575499, -0.16711043, -0.17568678,
    -0.18278688, -0.19129293, -0.20247031, -0.21146846, -0.21934183,
    -0.22763699, -0.23536977, -0.24528179, -0.25477201, -0.26510582,
    -0.27326038, -0.28232882, -0.28893683, -0.30004392, -0.30953414,
    -0.31993824, -0.32816311, -0.33723155, -0.34447224, -0.352908,
    -0.36282001, -0.37216965, -0.38292524, -0.39164219, -0.39895318,
    -0.40703745, -0.41835542, -0.42777535, -0.43621111,
], dtype=np.float32)

KITTI_INCLINATION = -KITTI_LASER_ZENITH  # reference :240

KITTI_WIDTH = 2048
KITTI_HEIGHT = 64

KITTI_NAME_TO_CLS = {"Car": 1, "Pedestrian": 2, "Cyclist": 4}


def _norm(t: torch.Tensor) -> torch.Tensor:
    """f32 Euclidean norm over the last axis as ``np.linalg.norm`` gives it:
    the squares summed in order, a correctly rounded square root (taken in
    float64: torch's f32 sqrt on the CPU is not)."""
    acc = t[..., 0] * t[..., 0]
    for k in range(1, t.shape[-1]):
        acc = acc + t[..., k] * t[..., k]
    return torch.sqrt(acc.double()).float()


def pixel_indices(pc: torch.Tensor, width: int = KITTI_WIDTH,
                  inclination: np.ndarray = KITTI_INCLINATION,
                  height_table: np.ndarray = KITTI_LASER_HEIGHT):
    """(N, 3+) f32 points -> (row, col) int64 (N,) each, and the float
    column before rounding, in the JAX builder's float32 order: row = the
    laser whose inclination is nearest the elevation seen from its mount
    height, col = round(W - 1/2 - (azimuth + pi) / (2 pi) W) clipped."""
    dev = pc.device
    incl = torch.from_numpy(np.asarray(inclination, np.float32)).to(dev)
    heights = torch.from_numpy(np.asarray(height_table, np.float32)).to(dev)
    xy_norm = _norm(pc[:, :2])
    # (N, L) elevation against every laser
    elev = torch.atan2(heights[None, :] - pc[:, 2:3], xy_norm[:, None])
    row = torch.argmin(torch.abs(incl[None, :] - elev), dim=1)
    azi = torch.atan2(pc[:, 1], pc[:, 0])
    # a divisor on the device: CUDA divides by a host scalar through its
    # reciprocal, which is not numpy's correctly rounded quotient
    two_pi = torch.tensor(2.0 * np.pi, dtype=torch.float32, device=dev)
    col_f = (width - 1.0 + 0.5) - (azi + np.pi) / two_pi * width
    col = torch.clamp(torch.round(col_f).long(), 0, width - 1)
    return row, col, col_f


def _as_points(pc, device) -> torch.Tensor:
    if not isinstance(pc, torch.Tensor):
        pc = torch.from_numpy(np.ascontiguousarray(pc, np.float32))
    return pc.float().to(checked_device(device))


def _nearest(pc: torch.Tensor, width: int, inclination, height_table):
    """-> (the pixel of each point, its range, whether it is at its
    pixel's least range)."""
    row, col, _ = pixel_indices(pc, width, inclination, height_table)
    pix = row * width + col
    point_range = _norm(pc[:, :3])
    best = torch.full((len(inclination) * width,), np.inf,
                      dtype=torch.float32, device=pc.device)
    best = best.scatter_reduce(0, pix, point_range, "amin")
    return pix, point_range, point_range == best[pix]


def build_range_image(pc, width: int = KITTI_WIDTH,
                      inclination: np.ndarray = KITTI_INCLINATION,
                      height_table: np.ndarray = KITTI_LASER_HEIGHT,
                      device="cuda") -> torch.Tensor:
    """Velodyne scan (N, 4+) [x, y, z, intensity, ...] (numpy or a tensor)
    -> (64, W, 5) [range, x, y, z, intensity] on ``device``; unobserved
    pixels are -1. The nearest point wins each pixel; among points of equal
    range, the last of the scan (get_range_image,
    create_range_image_in_kitti.py:107-137)."""
    pc = _as_points(pc, device)
    L = len(inclination)
    pix, point_range, nearest = _nearest(pc, width, inclination,
                                         height_table)
    winner = torch.full((L * width,), -1, dtype=torch.long, device=pc.device)
    winner = winner.scatter_reduce(
        0, pix[nearest], torch.arange(len(pc), device=pc.device)[nearest],
        "amax")
    vals = torch.cat([point_range[:, None], pc[:, :4]], dim=1)
    image = torch.full((L * width, 5), -1.0, dtype=torch.float32,
                       device=pc.device)
    hit = winner >= 0
    image[hit] = vals[winner[hit]]
    return image.reshape(L, width, 5)


def range_image_ties(pc, width: int = KITTI_WIDTH, device="cuda") -> int:
    """The pixels where two or more points share the least range: where the
    tie rule decides (numpy's unstable argsort may pick another)."""
    pc = _as_points(pc, device)
    pix, _, nearest = _nearest(pc, width, KITTI_INCLINATION,
                               KITTI_LASER_HEIGHT)
    n = torch.zeros(KITTI_HEIGHT * width, dtype=torch.long, device=pc.device)
    n = n.index_add(0, pix, nearest.long())
    return int((n > 1).sum())


class Calibration:
    """Minimal KITTI calib (P2 / R0_rect / Tr_velo_to_cam) with the standard
    rect <-> lidar transforms (reference kitti_utils/calibration_kitti.py),
    numpy on the host."""

    def __init__(self, calib_file: str):
        data: Dict[str, np.ndarray] = {}
        with open(calib_file) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, vals = line.split(":", 1)
                try:
                    data[key.strip()] = np.array(
                        [float(v) for v in vals.split()], np.float32)
                except ValueError:
                    continue
        self.P2 = data["P2"].reshape(3, 4)
        self.R0 = data["R0_rect"].reshape(3, 3)
        self.V2C = data["Tr_velo_to_cam"].reshape(3, 4)

    def rect_to_lidar(self, pts_rect: np.ndarray) -> np.ndarray:
        """(N, 3) rect-camera frame -> lidar frame."""
        pts_ref = pts_rect @ np.linalg.inv(self.R0).T
        # invert [R|t]: x_ref = R x_lidar + t  =>  x_lidar = R^T (x_ref - t)
        R, t = self.V2C[:, :3], self.V2C[:, 3]
        return (pts_ref - t) @ R

    def lidar_to_rect(self, pts_lidar: np.ndarray) -> np.ndarray:
        ref = pts_lidar @ self.V2C[:, :3].T + self.V2C[:, 3]
        return ref @ self.R0.T


def boxes_camera_to_lidar_csa(boxes_cam: np.ndarray,
                              calib: Calibration) -> np.ndarray:
    """KITTI camera-frame boxes [x, y, z, l, h, w, ry] (bottom centre) ->
    lidar-frame csa7 [cx, cy, cz (centre), l, w, h, yaw]."""
    boxes_cam = np.asarray(boxes_cam, np.float32).reshape(-1, 7)
    xyz_cam = boxes_cam[:, :3]
    l, h, w = boxes_cam[:, 3], boxes_cam[:, 4], boxes_cam[:, 5]
    ry = boxes_cam[:, 6]
    xyz = calib.rect_to_lidar(xyz_cam)
    xyz[:, 2] += h / 2.0  # bottom centre -> geometric centre
    yaw = -(ry + np.pi / 2.0)
    return np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2], l, w, h, yaw], axis=1)


def points_in_boxes_csa(pc, csa, device="cuda") -> np.ndarray:
    """Points-per-box counts for the roidb (the reference's builder keeps
    num_lidar_points_in_box per label for the difficulty rules): pc (N, 3)
    lidar frame, csa (M, 7) [cx, cy, cz, l, w, h, yaw] -> (M,) f32 counts,
    boundary-inclusive, computed on ``device`` over (M, N, 3)."""
    dev = checked_device(device)
    pc = torch.from_numpy(
        np.ascontiguousarray(np.asarray(pc, np.float32).reshape(-1, 3))).to(dev)
    csa = torch.from_numpy(
        np.ascontiguousarray(np.asarray(csa, np.float32).reshape(-1, 7))
    ).to(dev)
    if len(csa) == 0:
        return np.zeros((0,), np.float32)
    d = pc[None, :, :] - csa[:, None, :3]  # (M, N, 3)
    c, s = torch.cos(csa[:, 6])[:, None], torch.sin(csa[:, 6])[:, None]
    lx = d[..., 0] * c + d[..., 1] * s
    ly = -d[..., 0] * s + d[..., 1] * c
    inside = ((torch.abs(lx) <= csa[:, 3:4] / 2)
              & (torch.abs(ly) <= csa[:, 4:5] / 2)
              & (torch.abs(d[..., 2]) <= csa[:, 5:6] / 2))
    return inside.sum(dim=1).float().cpu().numpy()


def kitti_frame_to_inputs(
    velodyne: np.ndarray,
    pad_field,
    max_gt: int,
    gt_csa: Optional[np.ndarray] = None,
    gt_class: Optional[np.ndarray] = None,
    width: int = KITTI_WIDTH,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Raw KITTI scan -> the framework's padded batch-entry dict (numpy),
    the range image built on ``device``. KITTI has no elongation channel;
    it is zero-filled (the whitening then yields a constant, which the
    first conv absorbs)."""
    from .normalization import CHANNELS, clip_and_norm

    image = build_range_image(velodyne, width=width,
                              device=device).cpu().numpy()
    H, W = image.shape[:2]
    mask = (image[..., 0] > -1).astype(np.float32)
    rng_v = np.where(mask > 0, image[..., 0], 0.0)
    pc = np.where(mask[..., None] > 0, image[..., 1:4], 0.0)
    intensity = np.where(mask > 0, image[..., 4], 0.0)

    raw = {
        "range_value": rng_v,
        "intensity": intensity,
        "elongation": np.zeros_like(rng_v),
        "x": pc[..., 0],
        "y": pc[..., 1],
        "z": pc[..., 2],
        "inclination": np.broadcast_to(KITTI_INCLINATION[:, None],
                                       (H, W)).astype(np.float32),
        "azimuth": np.arctan2(pc[..., 1], pc[..., 0]).astype(np.float32),
    }
    chans = [clip_and_norm(n, raw[n]) for n in CHANNELS]
    input_data = np.stack(chans, axis=-1).astype(np.float32)
    coord = input_data[..., 3:6].copy()

    Hp, Wp = pad_field

    def pad(a):
        out = np.zeros((Hp, Wp) + a.shape[2:], np.float32)
        out[:H, : min(W, Wp)] = a[:, : min(W, Wp)]
        return out

    out_csa = np.zeros((max_gt, 7), np.float32)
    out_cls = np.zeros((max_gt,), np.float32)
    out_valid = np.zeros((max_gt,), np.float32)
    if gt_csa is not None and len(gt_csa):
        n = min(len(gt_csa), max_gt)
        out_csa[:n] = gt_csa[:n]
        out_cls[:n] = gt_class[:n]
        out_valid[:n] = 1.0

    return dict(
        input_data=pad(input_data),
        coord=pad(coord),
        pc=pad(pc),
        mask=pad(mask[..., None]),
        unnorm_range=pad((rng_v * mask)[..., None]),
        gt_csa=out_csa,
        gt_class=out_cls,
        gt_valid=out_valid,
    )
