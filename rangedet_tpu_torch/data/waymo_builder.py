"""Offline Waymo Open Dataset builder, the port's counterpart of
``rangedet_tpu/data/waymo_builder.py``: *.tfrecord segments -> per-frame
.npz range images + per-segment .roidb pickles, the files ``data/waymo.py``
reads.

The per-pixel geometry (the column azimuths, the spherical projection, the
lidar extrinsic, the zeroing of pixels without a return) runs as torch on
an explicit device, the card unless the caller asks for the CPU. The
roidb (labels, motion metadata, corners) is numpy on the host, as is the
npz write. TensorFlow and waymo_open_dataset are only needed to read the
tfrecords (``build_segment``); the body, ``build_segment_from_frames``,
takes any objects with the Frame proto's attribute surface.

One divergence from the JAX builder: the column azimuths follow Waymo's
``range_image_utils.compute_range_image_polar``, which SUBTRACTS the
extrinsic's yaw from the vehicle-frame column azimuths before the points
are rotated by the extrinsic. The JAX builder adds it, which turns every
point of a lidar mounted with yaw theta by 2 theta about the lidar. At a
yaw of 0 the two give the same column azimuths, bit for bit.
"""
from __future__ import annotations

import glob
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch


def checked_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA one must exist (no fallback to
    the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA card")
    return device


def azimuth_table(width: int, extrinsic_yaw_correction: float = 0.0,
                  device="cuda") -> torch.Tensor:
    """(W,) float64 sensor-frame azimuth of each column: the vehicle-frame
    azimuths pi - (i + 1/2) 2 pi / W (pi .. -pi left to right, the columns
    scan clockwise) less the extrinsic's yaw, wrapped to [-pi, pi)."""
    step = 2 * np.pi / width
    i = torch.arange(width, dtype=torch.float64,
                     device=checked_device(device))
    az = np.pi - step * (i + 0.5)
    return torch.remainder(az - extrinsic_yaw_correction + np.pi,
                           2 * np.pi) - np.pi


def spherical_to_cartesian(rng: torch.Tensor, inclination: torch.Tensor,
                           azimuth: torch.Tensor) -> torch.Tensor:
    """(H, W) f32 range + (H,) f32 inclination + (W,) f64 azimuth -> (H, W,
    3) f32 xyz, in the JAX builder's precision: x and y in float64 (the
    azimuth's), z in float32, then rounded to float32."""
    incl = inclination[:, None]
    az = azimuth[None, :]
    x = (rng * torch.cos(incl)).double() * torch.cos(az)
    y = (rng * torch.cos(incl)).double() * torch.sin(az)
    z = (rng * torch.sin(incl)).double()
    return torch.stack([x, y, z], dim=-1).float()


def corners_from_csa(csa: np.ndarray) -> np.ndarray:
    """(M, 7) csa -> (M, 8, 3) corners, bottom 4 then top 4 (numpy, for the
    roidb)."""
    csa = np.asarray(csa, np.float32).reshape(-1, 7)
    signs = np.array([[0.5, -0.5], [-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5]],
                     np.float32)
    lx = signs[None, :, 0] * csa[:, None, 3]
    wy = signs[None, :, 1] * csa[:, None, 4]
    c, s = np.cos(csa[:, 6])[:, None], np.sin(csa[:, 6])[:, None]
    x = lx * c - wy * s + csa[:, None, 0]
    y = lx * s + wy * c + csa[:, None, 1]
    bev = np.stack([x, y], axis=-1)
    z0 = (csa[:, 2] - csa[:, 5] / 2)[:, None, None] * np.ones((1, 4, 1),
                                                             np.float32)
    z1 = (csa[:, 2] + csa[:, 5] / 2)[:, None, None] * np.ones((1, 4, 1),
                                                             np.float32)
    return np.concatenate(
        [np.concatenate([bev, z0], -1), np.concatenate([bev, z1], -1)],
        axis=1)


def build_frame_record(
    frame_id: str,
    npz_path: str,
    gt_csa: np.ndarray,
    gt_class: np.ndarray,
    points_in_box: Optional[np.ndarray] = None,
    meta: Optional[dict] = None,
    motion: Optional[np.ndarray] = None,
) -> dict:
    """One roidb entry in the on-disk schema of the reference's
    LoadRecord/LoadGTInfo (rangedet/core/input.py:24-59): ``meta_data`` the
    per-label motion (M, 4) [speed_x, speed_y, accel_x, accel_y], the
    frame's name and timestamp in ``meta_info``."""
    gt_csa = np.asarray(gt_csa, np.float32).reshape(-1, 7)
    return {
        "rec_id": frame_id,
        "pc_url": npz_path,
        "gt_class": np.asarray(gt_class, np.float32).reshape(-1),
        "gt_bbox_csa": gt_csa,
        "gt_bbox_imu": corners_from_csa(gt_csa),
        "gt_bbox_yaw": gt_csa[:, 6].copy(),
        "points_in_box": (
            np.asarray(points_in_box, np.float32).reshape(-1)
            if points_in_box is not None
            else np.zeros((len(gt_csa),), np.float32)
        ),
        "meta_data": (
            np.asarray(motion, np.float32).reshape(-1, 4)
            if motion is not None
            else np.zeros((len(gt_csa), 4), np.float32)
        ),
        "meta_info": meta or {},
    }


def write_npz(path: str, **arrays) -> None:
    np.savez_compressed(path, **arrays)


def frame_geometry(ri: np.ndarray, calib, device) -> tuple:
    """One frame's range image (H, W, 4+) and laser calibration -> (pc
    (H, W, 3) f32 vehicle frame, zero where the range is <= 0; inclination
    (H,) f32 top row first; azimuth (W,) f64), computed on ``device``."""
    H, W = ri.shape[:2]
    if len(calib.beam_inclinations) > 0:
        inclination = np.array(calib.beam_inclinations, np.float32)[::-1]
    else:
        inclination = np.linspace(
            calib.beam_inclination_min, calib.beam_inclination_max, H
        ).astype(np.float32)[::-1]
    extrinsic = np.array(calib.extrinsic.transform, np.float32).reshape(4, 4)
    az_correction = float(np.arctan2(extrinsic[1, 0], extrinsic[0, 0]))
    azimuth = azimuth_table(W, az_correction, device)

    rng = torch.from_numpy(np.ascontiguousarray(ri[..., 0])).to(device)
    pc = spherical_to_cartesian(
        torch.clamp(rng, min=0),
        torch.from_numpy(inclination.copy()).to(device), azimuth)
    ext = torch.from_numpy(extrinsic).to(device)
    # rotate + translate into the vehicle frame by the lidar extrinsic
    pc = pc @ ext[:3, :3].T + ext[:3, 3]
    pc = torch.where((rng <= 0)[..., None], torch.zeros_like(pc), pc)
    return pc.cpu().numpy(), inclination, azimuth.cpu().numpy()


def build_segment_from_frames(
    frames, parse_range_images, out_dir: str, split: str, seg_name: str,
    lidar_name: int = 1, device="cuda",
) -> List[dict]:
    """The builder body, apart from the tfrecord IO: ``frames`` yields Frame
    protos (or any objects with their attribute surface) and
    ``parse_range_images(frame)`` returns {lidar_name: [range_image, ...]}
    where a range_image has ``.data`` (flat floats) and ``.shape.dims``.
    Writes ``out_dir/split/npz/<seg_name>_<i>.npz`` a frame and
    ``out_dir/split/<seg_name>.roidb``; returns the records.

    Mirrors get_data_from_seg (create_range_image_roidb.py:141-219), with
    the per-label motion metadata [speed_x, speed_y, accel_x, accel_y]
    (lines 180-186)."""
    device = checked_device(device)
    npz_dir = os.path.join(out_dir, split, "npz")
    os.makedirs(npz_dir, exist_ok=True)
    roidb = []

    for i, frame in enumerate(frames):
        range_images = parse_range_images(frame)
        ri = range_images[lidar_name][0]
        ri_np = np.array(ri.data, np.float32).reshape(ri.shape.dims)
        calib = [c for c in frame.context.laser_calibrations
                 if c.name == lidar_name][0]
        pc, inclination, azimuth = frame_geometry(ri_np, calib, device)

        gt_csa, gt_cls, pts_in_box, motion = [], [], [], []
        for label in frame.laser_labels:
            b = label.box
            gt_csa.append([b.center_x, b.center_y, b.center_z, b.length,
                           b.width, b.height, b.heading])
            gt_cls.append(label.type)
            pts_in_box.append(getattr(label, "num_lidar_points_in_box", -1))
            m = label.metadata
            motion.append([m.speed_x, m.speed_y, m.accel_x, m.accel_y])

        frame_id = f"{seg_name}_{i}"
        npz_path = os.path.join(npz_dir, f"{frame_id}.npz")
        write_npz(
            npz_path,
            range_image=ri_np[..., :4],
            pc_vehicle_frame=pc,
            inclination=inclination,
            azimuth=azimuth.astype(np.float32),
        )
        roidb.append(build_frame_record(
            frame_id, npz_path,
            np.array(gt_csa, np.float32).reshape(-1, 7),
            np.array(gt_cls, np.float32),
            np.array(pts_in_box, np.float32),
            meta={"name": frame.context.name,
                  "timestamp_micros": frame.timestamp_micros},
            motion=np.array(motion, np.float32).reshape(-1, 4),
        ))

    with open(os.path.join(out_dir, split, f"{seg_name}.roidb"), "wb") as f:
        pickle.dump(roidb, f)
    return roidb


def build_segment(tfrecord_path: str, out_dir: str, split: str,
                  lidar_name: int = 1, device="cuda") -> List[dict]:
    """One Waymo segment -> npz files + roidb list. Needs tensorflow and
    waymo_open_dataset for the tfrecord and proto IO."""
    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.utils import frame_utils
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "tensorflow + waymo_open_dataset are required for the offline "
            "tfrecord builder. Run this step in a Waymo-tooling "
            "environment, or convert with your own extractor into the "
            "npz/roidb schema (see data/waymo.py).") from e

    seg_name = os.path.basename(tfrecord_path).replace(".tfrecord", "")

    def frames():
        ds = tf.data.TFRecordDataset(tfrecord_path, compression_type="")
        for data in ds:
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytearray(data.numpy()))
            yield frame

    def parse(frame):
        (range_images, _, _, _) = (
            frame_utils.parse_range_image_and_camera_projection(frame))
        return range_images

    return build_segment_from_frames(frames(), parse, out_dir, split,
                                     seg_name, lidar_name, device)


def build_dataset(tfrecord_dir: str, out_dir: str, split: str,
                  num_workers: int = 8, lidar_name: int = 1,
                  device="cuda"):
    """Every ``*.tfrecord`` of ``tfrecord_dir``, threaded over segments
    (create_range_image_roidb.py:223-256)."""
    segs = sorted(glob.glob(os.path.join(tfrecord_dir, "*.tfrecord")))
    if not segs:
        raise FileNotFoundError(f"no *.tfrecord under {tfrecord_dir}")
    with ThreadPoolExecutor(num_workers) as ex:
        list(ex.map(lambda s: build_segment(s, out_dir, split, lidar_name,
                                            device), segs))
