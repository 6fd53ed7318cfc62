"""Waymo npz/roidb reading + host-side preprocessing: the port's own numpy
copy of ``rangedet_tpu/data/waymo.py`` (the port imports nothing of the JAX
package). ``record_to_inputs`` applies cfg.augment's geometric augmentations
(``data/augment.py``) to the raw frame before normalization, as the
reference does.

Consumes the same on-disk format the reference's offline builder produces
(datasets/create_range_image_roidb.py:141-219): per-frame ``.npz`` with
``pc_vehicle_frame`` (64,2650,3), ``range_image`` (64,2650,3+), ``inclination``
(64,), ``azimuth`` (2650,); per-segment ``.roidb`` pickle whose entries carry
``pc_url``, ``gt_class``, ``gt_bbox_csa`` (M,7), ``gt_bbox_imu`` (M,8,3).

Host work is deliberately thin — hole filling, clip/whiten, stack, pad — the
reference's heavy stages (assigner, GenerateTarget, FPN slicing:
rangedet/core/input.py:276-624) run on device inside the step.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import augment as _augment
from .normalization import CHANNELS, clip_and_norm

WAYMO_TYPE = {
    "TYPE_UNKNOWN": 0,
    "TYPE_VEHICLE": 1,
    "TYPE_PEDESTRIAN": 2,
    "TYPE_SIGN": 3,
    "TYPE_CYCLIST": 4,
}


def load_roidbs(
    data_root: str,
    image_set,
    sampling_rate: int = 1,
    filter_class: Optional[Sequence[str]] = None,
) -> List[dict]:
    """Glob + load per-segment roidb pickles, subsample, filter classes —
    mirrors tools/train.py:100-127."""
    if isinstance(image_set, str):
        image_sets = [image_set]
    else:
        image_sets = list(image_set)
    roidb: List[dict] = []
    for s in image_sets:
        for seg in sorted(glob.glob(os.path.join(data_root, s, "*.roidb"))):
            with open(seg, "rb") as f:
                roidb.extend(pickle.load(f, encoding="latin1"))
    roidb = roidb[::sampling_rate] if sampling_rate > 1 else roidb
    if filter_class:
        keep_ids = {WAYMO_TYPE[c] for c in filter_class}
        for rec in roidb:
            cls = np.asarray(rec.get("gt_class", np.zeros(0)))
            sel = np.isin(cls, list(keep_ids))
            for key in ("gt_class", "gt_bbox_csa", "gt_bbox_imu", "gt_bbox_yaw",
                        "points_in_box"):
                if key in rec and np.asarray(rec[key]).shape[:1] == cls.shape[:1]:
                    rec[key] = np.asarray(rec[key])[sel]
    return roidb


def fill_missing(range_image: np.ndarray, pc: np.ndarray):
    """Hole filling + car-window masking — ProcessMissValue
    (rangedet/core/input.py:89-137): shift-left-by-1 fill for isolated holes,
    then remaining holes get range 80 (background) or, when surrounded by
    returns within 2 px (car windows), zeroed with range 0.
    """
    H, W = range_image.shape[:2]
    miss = range_image[:, :, 0] == -1

    def shift1(data):
        out = data.copy()
        shifted = np.concatenate([data[:, 1:], data[:, :1]], axis=1)
        out[miss] = shifted[miss]
        return out

    range_image = shift1(range_image)
    pc = shift1(pc)
    mask = (range_image[:, :, 0] > 0).astype(np.float32)

    still_miss = range_image[:, :, 0] == -1
    down2 = np.roll(range_image[:, :, 0], 2, axis=0)
    up2 = np.roll(range_image[:, :, 0], -2, axis=0)
    right2 = np.roll(range_image[:, :, 0], 2, axis=1)
    left2 = np.roll(range_image[:, :, 0], -2, axis=1)
    car_window = still_miss & (
        (down2 != -1) | (up2 != -1) | (right2 != -1) | (left2 != -1)
    )

    fill = np.zeros((range_image.shape[-1],), np.float32)
    fill[0] = 80.0
    if range_image.shape[-1] >= 4:
        fill[3] = -1.0
    range_image[still_miss] = fill
    pc[still_miss] = 0.0
    cw_fill = np.zeros_like(fill)
    if range_image.shape[-1] >= 4:
        cw_fill[3] = -1.0
    range_image[car_window] = cw_fill
    pc[car_window] = 0.0
    return range_image, pc, mask


def record_to_inputs(rec: dict, pad_field, max_gt: int,
                     npz_cache: Optional[dict] = None,
                     augment: Sequence[str] = (),
                     aug_rng: Optional[np.random.RandomState] = None,
                     ) -> Dict[str, np.ndarray]:
    """One roidb record -> padded, normalized device-batch entry.

    ``augment`` names cfg.augment's geometric augmentations (data/augment.py),
    applied to the raw frame before normalization — the slot where the
    reference's transform list would run them (core/input.py transform order).
    They draw from ``aug_rng``, or from the global ``np.random`` when it is
    None, as the reference's loop leaves it.
    """
    url = rec["pc_url"]
    if npz_cache is not None and url in npz_cache:
        npkl = npz_cache[url]
    else:
        npkl = np.load(url)
        if npz_cache is not None:
            npz_cache[url] = npkl

    pc = npkl["pc_vehicle_frame"].astype(np.float32).copy()
    range_image = npkl["range_image"].astype(np.float32).copy()
    inclination = npkl["inclination"].astype(np.float32)
    valid0 = range_image[..., 0:1] > 0
    pc[~valid0[..., 0]] = 0

    range_image, pc, mask = fill_missing(range_image, pc)
    H, W = mask.shape

    # no-label-zone flag: channel 3 of the builder's range image (1.0 inside
    # an NLZ, -1.0 otherwise / for filled holes) — reference excludes NLZ
    # points from assignment (core/input.py:276-320 via assigner.h:29-44)
    if range_image.shape[-1] >= 4:
        is_in_nlz = range_image[..., 3].astype(np.float32)
    else:
        is_in_nlz = np.full((H, W), -1.0, np.float32)

    gt_class = np.asarray(rec.get("gt_class", np.zeros(0)), np.float32).reshape(-1)
    gt_csa = np.asarray(rec.get("gt_bbox_csa", np.zeros((0, 7))), np.float32).reshape(-1, 7)

    frame = {
        "range_value": range_image[..., 0],
        "intensity": range_image[..., 1],
        "elongation": range_image[..., 2],
        "pc": pc,
        "mask": mask,
        "is_in_nlz": is_in_nlz,
        "inclination": np.broadcast_to(inclination[:, None], (H, W)),
        "azimuth": np.arctan2(pc[..., 1], pc[..., 0]).astype(np.float32),
        "gt_csa": gt_csa,
        "gt_class": gt_class,
    }
    if augment:
        frame = _augment.apply_augmentations(
            frame, aug_rng if aug_rng is not None else np.random, augment
        )
        pc, mask, is_in_nlz = frame["pc"], frame["mask"], frame["is_in_nlz"]
        gt_csa, gt_class = frame["gt_csa"], frame["gt_class"]

    raw = {
        "range_value": frame["range_value"],
        "intensity": frame["intensity"],
        "elongation": frame["elongation"],
        "x": pc[..., 0],
        "y": pc[..., 1],
        "z": pc[..., 2],
        "inclination": frame["inclination"],
        "azimuth": frame["azimuth"],
    }
    unnorm_range = np.clip(raw["range_value"], 0, 80).astype(np.float32)
    chans = [clip_and_norm(n, raw[n]) for n in CHANNELS]
    input_data = np.stack(chans, axis=-1).astype(np.float32)
    coord = input_data[..., 3:6].copy()

    Hp, Wp = pad_field

    def pad(a):
        out = np.zeros((Hp, Wp) + a.shape[2:], np.float32)
        out[:H, :W] = a
        return out

    n = min(len(gt_class), max_gt)
    out_csa = np.zeros((max_gt, 7), np.float32)
    out_cls = np.zeros((max_gt,), np.float32)
    out_valid = np.zeros((max_gt,), np.float32)
    out_csa[:n] = gt_csa[:n]
    out_cls[:n] = gt_class[:n]
    out_valid[:n] = 1.0

    return dict(
        input_data=pad(input_data),
        coord=pad(coord),
        pc=pad(pc),
        mask=pad(mask[..., None]),
        unnorm_range=pad((unnorm_range * mask)[..., None]),
        is_in_nlz=pad(is_in_nlz[..., None]),
        gt_csa=out_csa,
        gt_class=out_cls,
        gt_valid=out_valid,
    )
