"""The traffic's frames: a frozen copy of the program's raytraced scene
generator (``rangedet_tpu_torch/data/synthetic.py:make_frame_vehicles``,
``frame_to_inputs``) and its input normalization
(``data/normalization.py``), so that a change to the program cannot change
the benchmark's inputs. numpy only.

Each frame is a 64 x 2650 range image (padded to the configuration's
width) of oriented cuboids raytraced from the sensor, z-buffered in front
of a background wall, with their boxes as ground truth; ``make_batch``
stacks frames into the batch the program's train and eval steps take.
``make_pool`` draws a traffic file's pool of distinct batches from a seed.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

CLIP = {
    "range_value": (0.0, 80.0),
    "intensity": (0.0, 1.0),
    "elongation": (0.0, 1.0),
    "x": (-80.0, 80.0),
    "y": (-80.0, 80.0),
    "z": (-5.0, 10.0),
    "inclination": (-0.5, 0.1),
    # azimuth is not clipped (SepAndClipData pops it, input.py:149)
}

NORM = {
    "range_value": (20.0, 1500.0),
    "intensity": (0.1, 0.01),
    "elongation": (7.2558375e-02, 2.6764875e-02),
    "x": (1.5672500e00, 3.0740625e02),
    "y": (9.8824875e-01, 2.1913250e02),
    "z": (1.4, 1.0),
    "inclination": (-8.8427375e-02, 9.9001750e-03),
    "azimuth": (-7.8061250e-03, 2.5494125e00),
}

# 8-channel input stack order (CombineDataParam, config:269-282)
CHANNELS = (
    "range_value", "intensity", "elongation", "x", "y", "z",
    "inclination", "azimuth",
)


def clip_and_norm(name: str, v: np.ndarray) -> np.ndarray:
    if name in CLIP:
        lo, hi = CLIP[name]
        v = np.clip(v, lo, hi)
    mean, var = NORM[name]
    return (v - mean) / np.sqrt(var)


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




def make_batch(states, boxes: int, feat_size, pad_w: int, max_gt: int,
               label_set) -> Dict[str, np.ndarray]:
    """One frame a seed state of ``states``, ``boxes`` raytraced boxes
    each, padded to ``pad_w`` columns and ``max_gt`` box rows
    (``gt_valid`` marks the real ones)."""
    H, W = feat_size
    out = {k: [] for k in
           ("input_data", "coord", "pc", "mask", "unnorm_range", "is_in_nlz",
            "gt_csa", "gt_class", "gt_valid")}
    for state in states:
        rng = np.random.RandomState(int(state))
        frame = make_frame_vehicles(rng, H, W, boxes, tuple(label_set))
        for k, v in frame_to_inputs(frame, pad_w).items():
            out[k].append(v)
        n = min(boxes, max_gt)
        rows = {"gt_csa": np.zeros((max_gt, 7), np.float32),
                "gt_class": np.zeros((max_gt,), np.float32),
                "gt_valid": np.zeros((max_gt,), np.float32)}
        rows["gt_csa"][:n] = frame["gt_csa"][:n]
        rows["gt_class"][:n] = frame["gt_class"][:n]
        rows["gt_valid"][:n] = 1.0
        for k, v in rows.items():
            out[k].append(v)
    return {k: np.stack(v) for k, v in out.items()}


def frame_states(seed: int, traffic: dict) -> np.ndarray:
    """The seed state of every frame of the pool: (batch, frame of the
    batch), from ``np.random.SeedSequence(seed)`` (any non-negative seed,
    however large)."""
    return np.random.SeedSequence(int(seed)).generate_state(
        traffic["pool_batches"] * traffic["frames_per_card"]).reshape(
        traffic["pool_batches"], traffic["frames_per_card"])


def make_pool(seed: int, traffic: dict, c: dict, batches=None,
              frames=None) -> List[Dict[str, np.ndarray]]:
    """The traffic's pool: ``pool_batches`` batches of ``frames_per_card``
    frames, or only the batches numbered in ``batches``; of each batch
    only the frames numbered in ``frames`` (a rank's rows of a global
    batch), where given."""
    states = frame_states(seed, traffic)
    if frames is not None:
        states = states[:, list(frames)]
    return [make_batch(states[i], traffic["boxes_per_frame"],
                       c["feat_size"], c["pad_field"][1], c["max_gt_boxes"],
                       c["label_set"])
            for i in (range(len(states)) if batches is None else batches)]
