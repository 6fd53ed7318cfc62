"""Raytraced synthetic scenes rendered on the card: the port's copy of
``rangedet_tpu/data/synthetic_device.py`` (the port imports nothing of the
JAX package), so a training step can take a fresh scene every step with no
frame crossing from the host.

Same scene family as the numpy generator (``data/synthetic.py:
make_frame_vehicles``): oriented cuboids (l != w, so yaw is identifiable
from the range profile) rendered by slab-method ray-OBB intersection,
z-buffered against each other, in front of a background wall; optional
unlabeled clutter (poles, wall segments) and mixed families. Same
invariants (every painted pixel's point lies strictly inside its GT box,
gt_num_points equals the assigner's count).

The work is split in two: ``draw_scenes`` draws a batch's random numbers
from a ``torch.Generator``, and ``render_scenes`` renders the frames from
those draws. The draws are the values JAX's ``make_batch_device`` draws from
its per-frame ``split(key, 14)`` keys, so a test can feed the renderer
JAX's own draws and hold the frames to JAX's.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .normalization import CHANNELS, CLIP, NORM

VEHICLE_DIMS = ((3.6, 5.4), (1.7, 2.1), (1.5, 2.0))  # (l, w, h) ranges
# unlabeled clutter families (poles / wall segments): rendered and
# z-buffered like objects (they occlude and add vertical structure) but
# excluded from GT and painted with BACKGROUND intensity, so geometry (not
# an intensity shortcut) must separate them from real objects
CLUTTER_DIMS = (
    ((0.15, 0.4), (0.15, 0.4), (2.0, 6.0)),   # pole
    ((3.0, 10.0), (0.2, 0.5), (1.5, 3.5)),    # wall / fence segment
)
CLUTTER_R = (5.0, 70.0)  # the clutter's range draw (m)
# mildly rectangular footprint so yaw stays identifiable under the
# canonical [-pi/2, pi/2) convention; walking-adult heights
PED_DIMS = ((0.9, 1.2), (0.6, 0.85), (1.6, 1.9))
# bicycle + rider: long/narrow footprint, rider-height
CYC_DIMS = ((1.6, 2.0), (0.5, 0.8), (1.4, 1.8))


def _families(families, dims, r_range, class_value):
    return families if families is not None else (
        (dims, r_range, class_value),)


def inclinations(H: int) -> np.ndarray:
    """(H,) f32 row inclinations, ``jnp.linspace(0.03, -0.3, H)`` computed
    as JAX computes it: start * (1 - step) + stop * step in f32 with step =
    iota / (H - 1), the last row exactly the stop."""
    start, stop = np.float32(0.03), np.float32(-0.3)
    if H == 1:
        return np.array([start], np.float32)
    step = np.arange(H - 1, dtype=np.float32) / np.float32(H - 1)
    out = start * (np.float32(1) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


def _uniform(shape, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def draw_scenes(generator: torch.Generator, B: int, H: int, W: int,
                num_boxes: int = 10, families=None, dims=VEHICLE_DIMS,
                r_range=(8.0, 50.0), class_value: float = 1.0,
                num_clutter: int = 0) -> Dict[str, torch.Tensor]:
    """The random numbers of B scenes, on the generator's device, batch
    axis leading: bg_row (B, H, 1) U(25, 75), bg_noise (B, H, W) U(-2, 2),
    drop_u (B, H, W) U(0, 1) (a pixel returns when > 0.05), fam (B, M)
    int64 family ids, u (B, M, 4) U(0, 1) (l, w, h, r within the family's
    ranges), az_c (B, M) U(-0.9 pi, 0.9 pi), row (B, M) int64 in [H/4,
    3H/4), yaw (B, M) U(-pi/2, pi/2), wall_gap (B, M + C) U(2, 8),
    int_obj (B, H, W) U(0.4, 1), int_bg U(0, 0.4), elong U(0, 0.3); with C
    = num_clutter > 0 also c_fam (B, C), c_u (B, C, 4), c_az, c_row, c_yaw
    (B, C)."""
    dev = generator.device
    F_ = len(_families(families, dims, r_range, class_value))
    M, C = num_boxes, num_clutter

    def u(shape, lo=0.0, hi=1.0):
        return _uniform(shape, lo, hi, generator, dev)

    def ri(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    d = dict(
        bg_row=u((B, H, 1), 25.0, 75.0),
        bg_noise=u((B, H, W), -2.0, 2.0),
        drop_u=u((B, H, W)),
        fam=ri((B, M), 0, F_),
        u=u((B, M, 4)),
        az_c=u((B, M), -math.pi * 0.9, math.pi * 0.9),
        row=ri((B, M), H // 4, 3 * H // 4),
        yaw=u((B, M), -math.pi / 2, math.pi / 2),
        wall_gap=u((B, M + C), 2.0, 8.0),
        int_obj=u((B, H, W), 0.4, 1.0),
        int_bg=u((B, H, W), 0.0, 0.4),
        elong=u((B, H, W), 0.0, 0.3),
    )
    if C:
        d.update(
            c_fam=ri((B, C), 0, len(CLUTTER_DIMS)),
            c_u=u((B, C, 4)),
            c_az=u((B, C), -math.pi * 0.9, math.pi * 0.9),
            c_row=ri((B, C), H // 4, 3 * H // 4),
            c_yaw=u((B, C), -math.pi / 2, math.pi / 2),
        )
    return d


def _table(rows, device):
    return torch.tensor(rows, dtype=torch.float32, device=device)


def _slab(o, dd, e):
    dd = torch.where(dd.abs() < 1e-9, 1e-9, dd)
    o, e = o[..., None, None], e[..., None, None]
    t1 = (-e - o) / dd
    t2 = (e - o) / dd
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def ray_boxes(d, cx, cy, cz, length, width, height, yaw):
    """Slab ray-OBB intersection of every ray with every box: rays ``d``
    (H, W, 3) unit directions from the origin, boxes as (..., K) tensors of
    their centres, extents and yaw -> (box_t, t_exit, hit), each (..., K,
    H, W): box_t the range of the hit, nudged strictly inside the box (the
    assigner's containment is strict), inf where the ray misses or enters
    within 0.5 m; t_exit the range where the ray leaves the box."""
    # rays and origin rotated into each box frame (rotation by -yaw)
    cos_y, sin_y = torch.cos(yaw)[..., None, None], torch.sin(yaw)[..., None,
                                                                    None]
    dx = cos_y * d[..., 0] + sin_y * d[..., 1]  # (..., K, H, W)
    dy = -sin_y * d[..., 0] + cos_y * d[..., 1]
    dz = d[..., 2].expand(dx.shape)
    cos_b, sin_b = torch.cos(yaw), torch.sin(yaw)
    ox = -(cos_b * cx + sin_b * cy)
    oy = -(-sin_b * cx + cos_b * cy)
    oz = -cz

    n1, f1 = _slab(ox, dx, length / 2)
    n2, f2 = _slab(oy, dy, width / 2)
    n3, f3 = _slab(oz, dz, height / 2)
    t_enter = torch.maximum(torch.maximum(n1, n2), n3)
    t_exit = torch.minimum(torch.minimum(f1, f2), f3)
    hit = (t_exit >= t_enter) & (t_enter > 0.5)
    t_hit = torch.minimum(t_enter + 5e-3, 0.5 * (t_enter + t_exit))
    return torch.where(hit, t_hit, math.inf), t_exit, hit


def raytrace_boxes(csa: torch.Tensor, inclination: torch.Tensor,
                   azimuth: torch.Tensor):
    """The render of explicit boxes from a sensor at the origin: csa (K, 7)
    [cx, cy, cz, l, w, h, yaw] in the sensor frame, the row inclinations
    (H,) and column azimuths (W,) of the rays -> (range (H, W), inf where
    no box is hit; owner (H, W) int64, the nearest box hit, -1 where none),
    on the tensors' device. A hit pixel's point lies 5 mm along its ray
    inside the face it entered (``ray_boxes``)."""
    incl = inclination.float()[:, None]
    az = azimuth.float()[None, :]
    d = torch.stack(torch.broadcast_tensors(
        torch.cos(incl) * torch.cos(az), torch.cos(incl) * torch.sin(az),
        torch.sin(incl)), dim=-1)
    box_t, _, _ = ray_boxes(d, *csa.float().unbind(-1))
    t = box_t.amin(dim=0)
    owner = torch.where(torch.isfinite(t), box_t.argmin(dim=0), -1)
    return t, owner


def render_scenes(draws: Dict[str, torch.Tensor], H: int, W: int,
                  pad_w: int, max_gt: int, num_boxes: int = 10,
                  families=None, dims=VEHICLE_DIMS, r_range=(8.0, 50.0),
                  class_value: float = 1.0, num_clutter: int = 0
                  ) -> Dict[str, torch.Tensor]:
    """The batched training dict (build_train_targets' contract, all f32,
    padded to pad_w columns) of the scenes ``draws`` describes
    (``draw_scenes``), on the draws' device. ``dims`` gives (length,
    width, height) uniform ranges (VEHICLE_DIMS / PED_DIMS / CYC_DIMS),
    ``class_value`` the gt_class (Waymo enum: 1 veh, 2 ped, 4 cyc); mixed
    scenes pass ``families``, (dims, r_range, class_value) triples, and
    each box draws one. ``num_clutter`` unlabeled clutter cuboids over
    CLUTTER_R occlude boxes, take the background intensity and never
    enter the GT."""
    fams = _families(families, dims, r_range, class_value)
    dev = draws["bg_noise"].device
    B = draws["bg_noise"].shape[0]
    M, C = num_boxes, num_clutter

    incl = torch.from_numpy(inclinations(H)).to(dev)
    az = math.pi - (2 * math.pi / W) * torch.arange(W, dtype=torch.float32,
                                                    device=dev)
    incl_g = incl[:, None].expand(H, W)
    az_g = az[None, :].expand(H, W)
    d = torch.stack([torch.cos(incl_g) * torch.cos(az_g),
                     torch.cos(incl_g) * torch.sin(az_g),
                     torch.sin(incl_g)], dim=-1)  # (H, W, 3) unit rays

    bg = draws["bg_row"] + draws["bg_noise"]  # (B, H, W)
    mask = (draws["drop_u"] > 0.05).float()

    fam_lo = _table([[dd[0][0], dd[1][0], dd[2][0], rr[0]]
                     for dd, rr, _ in fams], dev)
    fam_hi = _table([[dd[0][1], dd[1][1], dd[2][1], rr[1]]
                     for dd, rr, _ in fams], dev)
    fam_cls = _table([c for _, _, c in fams], dev)
    fam = draws["fam"]
    lwhr = fam_lo[fam] + draws["u"] * (fam_hi[fam] - fam_lo[fam])  # (B,M,4)
    box_cls = fam_cls[fam]
    az_c, row, yaw = draws["az_c"], draws["row"], draws["yaw"]
    if C:
        c_lo = _table([[dd[0][0], dd[1][0], dd[2][0], CLUTTER_R[0]]
                       for dd in CLUTTER_DIMS], dev)
        c_hi = _table([[dd[0][1], dd[1][1], dd[2][1], CLUTTER_R[1]]
                       for dd in CLUTTER_DIMS], dev)
        cf = draws["c_fam"]
        clwhr = c_lo[cf] + draws["c_u"] * (c_hi[cf] - c_lo[cf])
        lwhr = torch.cat([lwhr, clwhr], dim=1)
        az_c = torch.cat([az_c, draws["c_az"]], dim=1)
        row = torch.cat([row, draws["c_row"]], dim=1)
        yaw = torch.cat([yaw, draws["c_yaw"]], dim=1)
    length, width, height, r = lwhr.unbind(-1)  # (B, M + C) each

    incl_c = incl[row]
    cx = r * torch.cos(incl_c) * torch.cos(az_c)
    cy = r * torch.cos(incl_c) * torch.sin(az_c)
    cz = r * torch.sin(incl_c)
    gt_csa = torch.stack([cx, cy, cz, length, width, height, yaw],
                         dim=-1)[:, :M]

    box_t, t_exit, hit = ray_boxes(d, cx, cy, cz, length, width, height,
                                   yaw)

    # background wall a few meters behind each object's silhouette
    wall = torch.where(hit, t_exit, 0.0).amax(dim=(2, 3)) + draws["wall_gap"]
    bg = torch.maximum(
        bg, torch.where(hit, wall[..., None, None], 0.0).amax(dim=1))

    owner = box_t.argmin(dim=1)  # (B, H, W); clutter ids are >= M
    t_best = box_t.amin(dim=1)
    object_px = torch.isfinite(t_best) & (t_best < bg)
    rng_img = torch.where(object_px, t_best, bg)
    mask = torch.where(object_px, 1.0, mask)
    owner = torch.where(object_px, owner, -1)
    ids = torch.arange(M, device=dev)[None, :, None, None]
    gt_num_points = (owner[:, None] == ids).sum(dim=(2, 3)).float()

    rng_img = rng_img.clamp(1.0, 79.0)
    pc = rng_img[..., None] * d * mask[..., None]

    # clutter pixels deliberately take the BACKGROUND intensity band
    intensity = torch.where(object_px & (owner < M), draws["int_obj"],
                            draws["int_bg"])
    raw = {
        "range_value": rng_img * mask,
        "intensity": intensity,
        "elongation": draws["elong"],
        "x": pc[..., 0],
        "y": pc[..., 1],
        "z": pc[..., 2],
        "inclination": incl_g.expand(B, H, W),
        "azimuth": torch.atan2(pc[..., 1], pc[..., 0]),
    }
    input_data = torch.stack([_clip_and_norm(n, raw[n]) for n in CHANNELS],
                             dim=-1)

    def pad(a):  # (B, H, W, ...) -> (B, H, pad_w, ...), zero columns
        out = a.new_zeros((B, H, pad_w) + a.shape[3:])
        out[:, :, :W] = a
        return out

    def rows(a):  # (B, M, ...) -> (B, max_gt, ...), zero rows after M
        out = a.new_zeros((B, max_gt) + a.shape[2:])
        out[:, :M] = a
        return out

    return {
        "input_data": pad(input_data),
        "coord": pad(input_data[..., 3:6]),
        "pc": pad(pc),
        "mask": pad(mask[..., None]),
        "unnorm_range": pad((rng_img * mask)[..., None]),
        "is_in_nlz": pad(torch.full((B, H, W, 1), -1.0, device=dev)),
        "gt_csa": rows(gt_csa),
        "gt_class": rows(box_cls),
        "gt_valid": rows(torch.ones(B, M, device=dev)),
        "gt_num_points": rows(gt_num_points),
    }


def _clip_and_norm(name: str, v: torch.Tensor) -> torch.Tensor:
    if name in CLIP:
        lo, hi = CLIP[name]
        v = v.clamp(lo, hi)
    mean, var = NORM[name]
    # JAX's jnp.sqrt(var): the f32 square root of the f32 variance
    return (v - mean) / float(np.sqrt(np.float32(var)))


def make_batch_device(generator: torch.Generator, B: int, H: int, W: int,
                      pad_w: int, max_gt: int, **scene
                      ) -> Dict[str, torch.Tensor]:
    """B scenes drawn from ``generator`` and rendered on its device:
    ``draw_scenes`` then ``render_scenes`` with the scene options
    ``scene`` (num_boxes, families or dims / r_range / class_value,
    num_clutter)."""
    return render_scenes(draw_scenes(generator, B, H, W, **scene), H, W,
                         pad_w, max_gt, **scene)
