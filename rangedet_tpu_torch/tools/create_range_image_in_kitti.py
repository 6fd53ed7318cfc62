"""Offline KITTI range-image builder CLI of the PyTorch port, counterpart
of ``tools/create_range_image_in_kitti.py``:

    python -m rangedet_tpu_torch.tools.create_range_image_in_kitti \
        --kitti-root DIR --out-dir OUT [--split train] [--ids FILE] \
        [--width 2048] [--classes Car,Pedestrian,Cyclist] [--device cuda]

KITTI velodyne scans + labels -> per-frame npz + one roidb pickle
``OUT/<split>/kitti.roidb``, in the schema of the Waymo builder (range_image
(64, W, 4) [range, intensity, elongation = 0, nlz = -1], pc_vehicle_frame,
inclination, azimuth, and roidb entries with lidar-frame csa7 boxes), so
``rangedet_tpu_torch.tools.train --data-root OUT`` trains on KITTI with no
further glue. The reference's entry point is
datasets/create_range_image_in_kitti.py (range image :107-137, camera ->
lidar boxes :25-37, per-laser tables :211-240); the body is
``data/kitti.py``, the range image and the points-in-box counts on
``--device``.

The KITTI layout (the object devkit's):
  <kitti-root>/velodyne/<id>.bin   float32 (N, 4) [x, y, z, intensity]
  <kitti-root>/calib/<id>.txt      P2 / R0_rect / Tr_velo_to_cam
  <kitti-root>/label_2/<id>.txt    optional (absent for the test split)
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np

from rangedet_tpu_torch.data.kitti import (
    KITTI_INCLINATION,
    KITTI_NAME_TO_CLS,
    Calibration,
    boxes_camera_to_lidar_csa,
    build_range_image,
    points_in_boxes_csa,
)
from rangedet_tpu_torch.data.waymo_builder import build_frame_record, write_npz


def read_labels(label_file: str, calib: Calibration, classes):
    """label_2 rows -> (csa7 (M, 7), class enum (M,)). A row is: type trunc
    occ alpha bbox[4] h w l x y z ry (camera rect frame, bottom centre)."""
    csa, cls = [], []
    with open(label_file) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] not in classes:
                continue
            h, w, l = (float(v) for v in parts[8:11])
            x, y, z = (float(v) for v in parts[11:14])
            ry = float(parts[14])
            box_cam = np.array([[x, y, z, l, h, w, ry]], np.float32)
            csa.append(boxes_camera_to_lidar_csa(box_cam, calib)[0])
            cls.append(KITTI_NAME_TO_CLS[parts[0]])
    if not csa:
        return np.zeros((0, 7), np.float32), np.zeros((0,), np.float32)
    return np.stack(csa).astype(np.float32), np.array(cls, np.float32)


def build_frame(frame_id: str, kitti_root: str, npz_dir: str, width: int,
                classes, device="cuda") -> dict:
    velo = np.fromfile(
        os.path.join(kitti_root, "velodyne", f"{frame_id}.bin"), np.float32
    ).reshape(-1, 4)
    image = build_range_image(velo, width=width,
                              device=device).cpu().numpy()  # (64, W, 5)
    valid = image[..., 0] > 0

    # Waymo-schema range image [range, intensity, elongation, nlz]: KITTI
    # has no elongation (zero; the whitening folds the constant into the
    # first conv) and no no-label zones (-1, outside one, everywhere)
    range_image = np.stack(
        [
            np.where(valid, image[..., 0], -1.0),
            np.where(valid, image[..., 4], 0.0),
            np.zeros_like(image[..., 0]),
            np.full_like(image[..., 0], -1.0),
        ],
        axis=-1,
    ).astype(np.float32)
    pc = np.where(valid[..., None], image[..., 1:4], 0.0).astype(np.float32)

    # column-centre azimuths of build_range_image's
    # col = W - 0.5 - (azi + pi) / (2 pi) * W
    W = range_image.shape[1]
    azimuth = ((W - 0.5 - np.arange(W, dtype=np.float32)) / W) * (
        2.0 * np.pi) - np.pi

    gt_csa = np.zeros((0, 7), np.float32)
    gt_cls = np.zeros((0,), np.float32)
    label_file = os.path.join(kitti_root, "label_2", f"{frame_id}.txt")
    if os.path.exists(label_file):
        calib = Calibration(os.path.join(kitti_root, "calib",
                                         f"{frame_id}.txt"))
        gt_csa, gt_cls = read_labels(label_file, calib, classes)

    npz_path = os.path.join(npz_dir, f"{frame_id}.npz")
    write_npz(
        npz_path,
        range_image=range_image,
        pc_vehicle_frame=pc,
        inclination=KITTI_INCLINATION.astype(np.float32),
        azimuth=azimuth.astype(np.float32),
    )
    return build_frame_record(
        frame_id, npz_path, gt_csa, gt_cls,
        points_in_box=points_in_boxes_csa(velo[:, :3], gt_csa, device),
        meta={"name": frame_id},
    )


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kitti-root", required=True,
                   help="dir holding velodyne/ calib/ [label_2/]")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--ids", default=None,
                   help="optional file of frame ids (one per line); default: "
                        "every velodyne/*.bin")
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--classes", default="Car,Pedestrian,Cyclist")
    p.add_argument("--device", default="cuda",
                   help="where the range images and box counts are computed "
                        "(cuda, or cpu)")
    args = p.parse_args(argv)

    classes = set(args.classes.split(","))
    unknown = classes - set(KITTI_NAME_TO_CLS)
    if unknown:
        p.error(f"unknown KITTI classes: {sorted(unknown)}")

    if args.ids:
        with open(args.ids) as f:
            ids = [ln.strip() for ln in f if ln.strip()]
    else:
        ids = sorted(
            os.path.splitext(os.path.basename(b))[0]
            for b in glob.glob(os.path.join(args.kitti_root, "velodyne",
                                            "*.bin")))
    if not ids:
        p.error(f"no frames found under {args.kitti_root}/velodyne")

    npz_dir = os.path.join(args.out_dir, args.split, "npz")
    os.makedirs(npz_dir, exist_ok=True)
    roidb = [build_frame(i, args.kitti_root, npz_dir, args.width, classes,
                         args.device) for i in ids]
    out = os.path.join(args.out_dir, args.split, "kitti.roidb")
    with open(out, "wb") as f:
        pickle.dump(roidb, f)
    print(f"wrote {len(roidb)} frames -> {out}")
    return roidb


if __name__ == "__main__":
    main()
