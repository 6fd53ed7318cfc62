"""Synthetic range-image scenes with consistent geometry: lidar-like frames
whose painted "objects" really contain their pixels' 3D points, so the full
assignment → target → loss path behaves like real data.

The port's own copy of ``rangedet_tpu/data/synthetic.py`` (numpy only), so
that the port imports nothing of the JAX package; it makes the same batches
from the same seed (tests/test_torch_train_ops.py holds the two together).
``write_waymo_files`` (the port's own) writes such frames as dataset files.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from .normalization import CHANNELS, clip_and_norm


def make_frame(
    rng: np.random.RandomState,
    H: int = 64,
    W: int = 2650,
    num_boxes: int = 10,
    class_choices=(1,),
) -> Dict[str, np.ndarray]:
    """One unpadded frame: range_image channels, pc, mask, gt boxes."""
    inclination = np.linspace(0.03, -0.3, H).astype(np.float32)  # top row up
    azimuth = np.linspace(np.pi, -np.pi, W, endpoint=False).astype(np.float32)

    # smooth-ish background range field
    base = rng.uniform(12.0, 70.0, (H, 1)).astype(np.float32)
    wobble = rng.uniform(-2, 2, (H, W)).astype(np.float32)
    rng_img = base + wobble
    mask = (rng.uniform(0, 1, (H, W)) > 0.05).astype(np.float32)

    # paint boxes: each is a rectangular pixel patch at a chosen range
    gt_csa = np.zeros((num_boxes, 7), np.float32)
    gt_class = np.zeros((num_boxes,), np.float32)
    for b in range(num_boxes):
        r = rng.uniform(5.0, 60.0)
        az_c = rng.uniform(-np.pi * 0.9, np.pi * 0.9)
        col = int((np.pi - az_c) / (2 * np.pi) * W) % W
        row = rng.randint(H // 4, 3 * H // 4)
        half_w = max(2, int(120.0 / r))
        half_h = 3
        r0, r1 = max(0, row - half_h), min(H, row + half_h)
        c0, c1 = col - half_w, col + half_w
        cols = np.arange(c0, c1) % W
        rows = np.arange(r0, r1)
        rr = r + rng.uniform(-0.3, 0.3, (len(rows), len(cols))).astype(np.float32)
        rng_img[np.ix_(rows, cols)] = rr
        mask[np.ix_(rows, cols)] = 1.0

        # box parameters chosen to contain all painted points
        incl_c = inclination[rows].mean()
        cx = r * np.cos(incl_c) * np.cos(az_c)
        cy = r * np.cos(incl_c) * np.sin(az_c)
        cz = r * np.sin(incl_c)
        ang_w = half_w * 2 * np.pi / W
        extent_xy = 2 * (r * np.tan(ang_w) + 1.5)
        extent_z = 2 * (
            r * np.tan((inclination[r0] - inclination[r1 - 1]) / 2) + 1.0
        )
        gt_csa[b] = [cx, cy, cz, extent_xy, extent_xy, abs(extent_z) + 1.0,
                     rng.uniform(-np.pi, np.pi)]
        gt_class[b] = rng.choice(class_choices)

    rng_img = np.clip(rng_img, 1.0, 79.0)
    incl_grid = np.broadcast_to(inclination[:, None], (H, W))
    az_grid = np.broadcast_to(azimuth[None, :], (H, W))
    x = rng_img * np.cos(incl_grid) * np.cos(az_grid)
    y = rng_img * np.cos(incl_grid) * np.sin(az_grid)
    z = rng_img * np.sin(incl_grid)
    pc = np.stack([x, y, z], axis=-1).astype(np.float32) * mask[..., None]

    return dict(
        range_value=rng_img.astype(np.float32) * mask,
        intensity=rng.uniform(0, 1, (H, W)).astype(np.float32),
        elongation=rng.uniform(0, 0.3, (H, W)).astype(np.float32),
        pc=pc,
        mask=mask,
        inclination=incl_grid.astype(np.float32),
        azimuth=np.arctan2(pc[..., 1], pc[..., 0]).astype(np.float32),
        gt_csa=gt_csa,
        gt_class=gt_class,
    )


# per-class (dims, r_range) — mirrors data/synthetic_device.py's
# VEHICLE_DIMS / PED_DIMS / CYC_DIMS families (Waymo enum keys)
CLASS_FAMILIES = {
    1: (((3.6, 5.4), (1.7, 2.1), (1.5, 2.0)), (8.0, 50.0)),
    2: (((0.9, 1.2), (0.6, 0.85), (1.6, 1.9)), (5.0, 35.0)),
    4: (((1.6, 2.0), (0.5, 0.8), (1.4, 1.8)), (5.0, 40.0)),
}


def make_frame_vehicles(
    rng: np.random.RandomState,
    H: int = 64,
    W: int = 2650,
    num_boxes: int = 10,
    class_choices=(1,),
    dims=None,
    r_range=None,
    inclination=None,
    azimuth=None,
    num_clutter: int = 0,
    clutter_r=(5.0, 70.0),
) -> Dict[str, np.ndarray]:
    """One unpadded frame with RAYTRACED vehicle-like boxes.

    Unlike :func:`make_frame`'s range-constant "billboard" patches (whose
    square GT boxes make yaw unidentifiable from the input), each object here
    is a true oriented cuboid (l≠w, vehicle-scale dims) rendered by exact
    ray-OBB intersection: every painted pixel's range is the slab-method entry
    distance of that pixel's lidar ray into the box, so the range profile
    across the object encodes the visible faces — yaw, extent, and center are
    all recoverable from the image, which makes held-out generalization (and
    APH) a meaningful test. Objects z-buffer against each other and stand in
    front of a background wall a few meters behind (partial occlusion between
    boxes is possible and realistic).

    Returns the same dict as make_frame plus ``gt_num_points`` (pixels owned
    per box — feeds the WOD L1/L2 difficulty rule, eval/ap.py:gt_difficulty).
    """
    # explicit tables let callers render with an exact sensor convention,
    # e.g. the half-pixel-centred column azimuths of the port's builder
    # (rangedet_tpu_torch/data/waymo_builder.py:azimuth_table)
    if inclination is None:
        inclination = np.linspace(0.03, -0.3, H).astype(np.float32)
    else:
        inclination = np.asarray(inclination, np.float32)
    if azimuth is None:
        azimuth = np.linspace(np.pi, -np.pi, W, endpoint=False).astype(np.float32)
    else:
        azimuth = np.asarray(azimuth, np.float32)
    col_pitch = 2 * np.pi / W
    row_pitch = (inclination[0] - inclination[-1]) / max(H - 1, 1)

    base = rng.uniform(25.0, 75.0, (H, 1)).astype(np.float32)
    wobble = rng.uniform(-2, 2, (H, W)).astype(np.float32)
    bg = base + wobble
    mask = (rng.uniform(0, 1, (H, W)) > 0.05).astype(np.float32)

    incl_grid = np.broadcast_to(inclination[:, None], (H, W))
    az_grid = np.broadcast_to(azimuth[None, :], (H, W))

    # unlabeled clutter (poles / wall segments — synthetic_device.CLUTTER_DIMS
    # twin): z-buffered like objects, excluded from GT, background intensity
    CLUTTER = (((0.15, 0.4), (0.15, 0.4), (2.0, 6.0)),
               ((3.0, 10.0), (0.2, 0.5), (1.5, 3.5)))
    total = num_boxes + num_clutter
    gt_csa = np.zeros((num_boxes, 7), np.float32)
    gt_class = np.zeros((num_boxes,), np.float32)
    box_t = np.full((H, W, total), np.inf, np.float32)

    for b in range(total):
        is_clutter = b >= num_boxes
        if is_clutter:
            dims_b = CLUTTER[rng.randint(len(CLUTTER))]
            rr_b = clutter_r
        else:
            cls_b = int(rng.choice(class_choices))
            # explicit dims/r_range override the per-class family tables
            dims_b, rr_b = CLASS_FAMILIES.get(cls_b, CLASS_FAMILIES[1])
            dims_b = dims if dims is not None else dims_b
            rr_b = r_range if r_range is not None else rr_b
        r = rng.uniform(*rr_b)
        az_c = rng.uniform(-np.pi * 0.9, np.pi * 0.9)
        row = rng.randint(H // 4, 3 * H // 4)
        incl_c = inclination[row]
        length = rng.uniform(*dims_b[0])
        width = rng.uniform(*dims_b[1])
        height = rng.uniform(*dims_b[2])
        # canonical yaw in [-pi/2, pi/2): a cuboid is pi-symmetric, so the
        # heading *direction* is not recoverable from geometry — labeling it
        # uniform over [-pi, pi) makes the cos/sin-Δyaw regression target
        # bimodal (±) and the conditional mean degenerate, which caps
        # held-out AP near zero while overfit runs still memorize it. The
        # canonical range makes the target a function of the scene; box
        # corners (and hence IoU) are unchanged by the convention.
        yaw = rng.uniform(-np.pi / 2, np.pi / 2)
        cx = r * np.cos(incl_c) * np.cos(az_c)
        cy = r * np.cos(incl_c) * np.sin(az_c)
        cz = r * np.sin(incl_c)
        if not is_clutter:
            gt_csa[b] = [cx, cy, cz, length, width, height, yaw]
            gt_class[b] = cls_b

        # restrict the exact intersection to the box's angular window
        half_diag = 0.5 * np.hypot(length, width) + 0.3
        ang_w = np.arctan2(half_diag, max(r - half_diag, 1.0))
        ang_h = np.arctan2(height / 2 + 0.3, max(r - half_diag, 1.0))
        col_c = int(round((np.pi - az_c) / col_pitch)) % W
        hw = min(int(np.ceil(ang_w / col_pitch)) + 1, W // 2)
        hh = min(int(np.ceil(ang_h / row_pitch)) + 1, H)
        rows = np.arange(max(0, row - hh), min(H, row + hh + 1))
        cols = np.arange(col_c - hw, col_c + hw + 1) % W
        sub_i = incl_grid[np.ix_(rows, cols)]
        sub_a = az_grid[np.ix_(rows, cols)]
        d = np.stack(
            [
                np.cos(sub_i) * np.cos(sub_a),
                np.cos(sub_i) * np.sin(sub_a),
                np.sin(sub_i),
            ],
            axis=-1,
        )  # (h, w, 3) unit ray directions from the sensor at the origin

        # slab method in the box frame (rotate by -yaw about z)
        cos_y, sin_y = np.cos(yaw), np.sin(yaw)
        rot = np.array(
            [[cos_y, sin_y, 0.0], [-sin_y, cos_y, 0.0], [0.0, 0.0, 1.0]],
            np.float32,
        )
        o_b = rot @ np.array([-cx, -cy, -cz], np.float32)  # ray origin
        d_b = d @ rot.T
        ext = np.array([length / 2, width / 2, height / 2], np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-ext - o_b) / d_b
            t2 = (ext - o_b) / d_b
        t_near = np.nanmin(np.stack([t1, t2]), axis=0)  # (h, w, 3)
        t_far = np.nanmax(np.stack([t1, t2]), axis=0)
        t_enter = t_near.max(axis=-1)
        t_exit = t_far.min(axis=-1)
        hit = (t_exit >= t_enter) & (t_enter > 0.5)
        # nudge strictly inside the box (the assigner's containment is
        # strict, assigner.h:29-51) without leaving short grazing chords
        t_hit = np.minimum(t_enter + 5e-3, 0.5 * (t_enter + t_exit))
        sub = box_t[np.ix_(rows, cols)]  # fancy-index copy; written back below
        sub[..., b] = np.where(hit, t_hit, np.inf)
        box_t[np.ix_(rows, cols)] = sub
        # background wall a few meters behind the object's window
        wall = t_exit[hit].max(initial=r) + rng.uniform(2.0, 8.0)
        bg_sub = bg[np.ix_(rows, cols)]
        bg[np.ix_(rows, cols)] = np.where(hit, np.maximum(bg_sub, wall), bg_sub)

    owner = np.argmin(box_t, axis=-1)  # (H, W); clutter ids are >= num_boxes
    t_best = np.min(box_t, axis=-1)
    object_px = np.isfinite(t_best) & (t_best < bg)
    rng_img = np.where(object_px, t_best, bg).astype(np.float32)
    mask = np.where(object_px, 1.0, mask).astype(np.float32)
    owner = np.where(object_px, owner, -1)
    real_px = object_px & (owner < num_boxes)
    gt_num_points = np.bincount(
        owner[(owner >= 0) & (owner < num_boxes)].ravel(),
        minlength=num_boxes,
    ).astype(np.float32)[:num_boxes]

    rng_img = np.clip(rng_img, 1.0, 79.0)
    x = rng_img * np.cos(incl_grid) * np.cos(az_grid)
    y = rng_img * np.cos(incl_grid) * np.sin(az_grid)
    z = rng_img * np.sin(incl_grid)
    pc = np.stack([x, y, z], axis=-1).astype(np.float32) * mask[..., None]

    return dict(
        range_value=rng_img * mask,
        intensity=np.where(
            real_px, rng.uniform(0.4, 1.0, (H, W)), rng.uniform(0, 0.4, (H, W))
        ).astype(np.float32),
        elongation=rng.uniform(0, 0.3, (H, W)).astype(np.float32),
        pc=pc,
        mask=mask,
        inclination=incl_grid.astype(np.float32),
        azimuth=np.arctan2(pc[..., 1], pc[..., 0]).astype(np.float32),
        gt_csa=gt_csa,
        gt_class=gt_class,
        gt_num_points=gt_num_points,
    )


def frame_to_inputs(frame: Dict[str, np.ndarray], pad_w: int) -> Dict[str, np.ndarray]:
    """Normalize + stack the 8 input channels and pad W (PadData equivalent)."""
    H, W = frame["mask"].shape
    raw = {
        "range_value": frame["range_value"],
        "intensity": frame["intensity"],
        "elongation": frame["elongation"],
        "x": frame["pc"][..., 0],
        "y": frame["pc"][..., 1],
        "z": frame["pc"][..., 2],
        "inclination": frame["inclination"],
        "azimuth": frame["azimuth"],
    }
    chans = [clip_and_norm(n, raw[n]) for n in CHANNELS]
    input_data = np.stack(chans, axis=-1).astype(np.float32)
    coord = input_data[..., 3:6].copy()  # normalized xyz (GetCoordinates)

    def pad(a):
        out = np.zeros((H, pad_w) + a.shape[2:], np.float32)
        out[:, :W] = a
        return out

    return dict(
        input_data=pad(input_data),
        coord=pad(coord),
        pc=pad(frame["pc"]),
        mask=pad(frame["mask"][..., None]),
        unnorm_range=pad((frame["range_value"] * frame["mask"])[..., None]),
        is_in_nlz=pad(frame.get(
            "is_in_nlz", np.full((H, W), -1.0, np.float32))[..., None]),
    )


def make_batch(
    cfg,
    batch_size: int = None,
    seed: int = 0,
    num_boxes: int = 10,
    style: str = "paint",
) -> Dict[str, np.ndarray]:
    """Batched, padded training batch matching build_train_targets' contract.

    style: "paint" (fast billboard patches, the unit-test default) or
    "vehicles" (raytraced oriented cuboids, make_frame_vehicles — used for
    the held-out quality runs where yaw must be learnable).
    """
    rng = np.random.RandomState(seed)
    B = batch_size or cfg.batch_image
    H, W = cfg.feat_size
    pad_w = cfg.pad_field[1]
    M = cfg.max_gt_boxes
    maker = make_frame_vehicles if style == "vehicles" else make_frame

    out = {k: [] for k in
           ("input_data", "coord", "pc", "mask", "unnorm_range", "is_in_nlz",
            "gt_csa", "gt_class", "gt_valid", "gt_num_points")}
    for _ in range(B):
        frame = maker(rng, H, W, num_boxes, tuple(cfg.label_set))
        inputs = frame_to_inputs(frame, pad_w)
        for k, v in inputs.items():
            out[k].append(v)
        gt_csa = np.zeros((M, 7), np.float32)
        gt_class = np.zeros((M,), np.float32)
        gt_valid = np.zeros((M,), np.float32)
        gt_np = np.zeros((M,), np.float32)
        n = min(num_boxes, M)
        gt_csa[:n] = frame["gt_csa"][:n]
        gt_class[:n] = frame["gt_class"][:n]
        gt_valid[:n] = 1.0
        if "gt_num_points" in frame:
            gt_np[:n] = frame["gt_num_points"][:n]
        else:  # painter: count via containment not needed; mark all dense
            gt_np[:n] = 100.0
        out["gt_csa"].append(gt_csa)
        out["gt_class"].append(gt_class)
        out["gt_valid"].append(gt_valid)
        out["gt_num_points"].append(gt_np)
    return {k: np.stack(v) for k, v in out.items()}


def write_waymo_files(root: str, n_frames: int, H: int = 64, W: int = 2650,
                      seed: int = 0, image_set: str = "validation",
                      num_boxes: int = 10,
                      class_choices: Sequence[int] = (1,)) -> List[dict]:
    """Write ``n_frames`` seeded make_frame_vehicles frames in the offline
    builder's on-disk format (``data/waymo.py`` reads it): one ``.npz`` per
    frame under ``root/<image_set>/``, so splits written under one root keep
    apart (pc_vehicle_frame (H, W, 3); range_image (H, W, 4)
    with range -1 at holes (rays without a return and ~2% dropped pixels)
    and channel 3 the no-label-zone flag, 1 on one strip of rows and
    columns and -1 elsewhere; inclination (H,); azimuth (W,)) and one
    ``root/<image_set>/synthetic.roidb`` pickle of their records (rec_id,
    pc_url, gt_class, gt_bbox_csa, points_in_box, meta_info). Returns the
    records."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, image_set), exist_ok=True)
    recs = []
    for i in range(n_frames):
        f = make_frame_vehicles(rng, H, W, num_boxes, tuple(class_choices))
        holes = (f["mask"] == 0) | (rng.uniform(size=(H, W)) < 0.02)
        nlz = np.full((H, W), -1.0, np.float32)
        r0, c0 = rng.randint(0, H - H // 8), rng.randint(0, W - W // 16)
        nlz[r0:r0 + max(1, H // 8), c0:c0 + max(1, W // 16)] = 1.0
        range_image = np.stack(
            [np.where(holes, -1.0, f["range_value"]), f["intensity"],
             f["elongation"], nlz], -1).astype(np.float32)
        path = os.path.abspath(os.path.join(root, image_set,
                                            f"frame_{i:04d}.npz"))
        np.savez(path, pc_vehicle_frame=f["pc"].astype(np.float32),
                 range_image=range_image,
                 inclination=f["inclination"][:, 0].astype(np.float32),
                 azimuth=f["azimuth"][H // 2].astype(np.float32))
        recs.append(dict(
            rec_id=f"synthetic_{seed}_{i:04d}", pc_url=path,
            gt_class=f["gt_class"].astype(np.float32),
            gt_bbox_csa=f["gt_csa"].astype(np.float32),
            points_in_box=f["gt_num_points"].astype(np.float32),
            meta_info={"name": f"synthetic_{seed}", "timestamp_micros": i}))
    with open(os.path.join(root, image_set, "synthetic.roidb"), "wb") as fh:
        pickle.dump(recs, fh)
    return recs
