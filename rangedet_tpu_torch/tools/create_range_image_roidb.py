"""Offline Waymo dataset builder CLI of the PyTorch port, counterpart of
``tools/create_range_image_roidb.py``:

    python -m rangedet_tpu_torch.tools.create_range_image_roidb \
        --tfrecord-dir DIR --out-dir OUT [--split training] [--workers 8] \
        [--lidar-name 1] [--device cuda]

Waymo tfrecord segments -> per-frame npz (range_image, pc_vehicle_frame,
inclination, azimuth) + per-segment roidb pickles under ``OUT/<split>/``,
the files ``rangedet_tpu_torch.tools.train --data-root OUT`` reads. The
reference's entry point is datasets/create_range_image_roidb.py (:223-256
threaded over segments, :141-219 a segment); the body is
``data/waymo_builder.py``, its geometry on ``--device``. Reading the
tfrecords needs tensorflow and waymo_open_dataset.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tfrecord-dir", required=True,
                   help="dir of segment-*.tfrecord files")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--lidar-name", type=int, default=1,
                   help="laser to rasterize (1 = TOP, dataset_pb2.LaserName)")
    p.add_argument("--device", default="cuda",
                   help="where the geometry runs (cuda, or cpu)")
    args = p.parse_args(argv)

    from rangedet_tpu_torch.data.waymo_builder import build_dataset

    build_dataset(args.tfrecord_dir, args.out_dir, args.split,
                  num_workers=args.workers, lidar_name=args.lidar_name,
                  device=args.device)
    print(f"built {args.split} under {args.out_dir}")


if __name__ == "__main__":
    main()
