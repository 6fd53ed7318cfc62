"""Plain train targets of RangeDet, from the raw batch: point-to-box
assignment, dense per-pixel regression targets and weights, range-interval
masks and the stride slices (the authors' host pipeline,
rangedet/core/input.py GenerateTarget / GenerateFPNTarget, and the
assigner operator_cxx/src_cxx/assigner.h). f32, channels last.

A point is assigned to the first box (lowest index) that contains it:
squared centre distance <= radius_sq, bottom < z < top, the four BEV edge
dot products > 0; the point must be valid, outside any no-label zone,
inside the valid boxes' extent and within max_dist_sq of the nearest
centre. The regression target of an assigned point, in its azimuth frame:
[signed sqrt dx, signed sqrt dy, log w, log l, cos dyaw, sin dyaw,
bottom z, log h]; its weight per dim ``reg_dim_weights``; its normalizer 1
/ (points in its box).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

CORNER_SIGNS = ((0.5, -0.5), (-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5))


def corners_bev(csa: torch.Tensor) -> torch.Tensor:
    """[cx, cy, cz, l, w, h, yaw] (..., 7) -> BEV corners (..., 4, 2):
    A(+l,-w) B(-l,-w) C(-l,+w) D(+l,+w), halved."""
    s = torch.tensor(CORNER_SIGNS, dtype=csa.dtype, device=csa.device)
    lx = s[:, 0] * csa[..., 3:4]
    wy = s[:, 1] * csa[..., 4:5]
    cos, sin = torch.cos(csa[..., 6:7]), torch.sin(csa[..., 6:7])
    x = lx * cos - wy * sin + csa[..., 0:1]
    y = lx * sin + wy * cos + csa[..., 1:2]
    return torch.stack([x, y], dim=-1)


def corners_3d(csa: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 8, 3): the bottom four corners, then the top."""
    bev = corners_bev(csa)
    cz, h = csa[..., 2], csa[..., 5]
    bot = (cz - 0.5 * h)[..., None, None].expand(bev[..., :1].shape)
    top = (cz + 0.5 * h)[..., None, None].expand(bev[..., :1].shape)
    return torch.cat([torch.cat([bev, bot], -1), torch.cat([bev, top], -1)],
                     dim=-2)


def assign(points: torch.Tensor, csa: torch.Tensor, point_mask: torch.Tensor,
           box_valid: torch.Tensor, nlz: torch.Tensor, radius_sq: float,
           max_dist_sq: float) -> torch.Tensor:
    """points (N, 3), csa (M, 7), point_mask (N,), box_valid (M,), nlz (N,)
    -> (N,) index of the assigned box, -1 for none."""
    c8 = corners_3d(csa)
    A, B, C, D, E = (c8[:, i] for i in range(5))
    centre = c8.mean(dim=1)
    d2 = ((points[:, None] - centre[None]) ** 2).sum(-1)  # (N, M)
    px, py, pz = points[:, 0:1], points[:, 1:2], points[:, 2:3]

    def edge(c0, c1, anchor):
        return ((c1[:, 0] - c0[:, 0])[None] * (px - anchor[None, :, 0])
                + (c1[:, 1] - c0[:, 1])[None] * (py - anchor[None, :, 1]))

    valid = box_valid > 0.5
    inside = ((pz > A[None, :, 2]) & (pz < E[None, :, 2])
              & (edge(B, A, B) > 0) & (edge(B, C, B) > 0)
              & (edge(D, A, D) > 0) & (edge(D, C, D) > 0)
              & (d2 <= radius_sq) & valid[None])
    d2 = torch.where(valid[None], d2, torch.full_like(d2, float("inf")))
    lo = [torch.where(valid[:, None], c8[..., k], torch.full_like(
        c8[..., k], float("inf"))).min() for k in range(3)]
    hi = [torch.where(valid[:, None], c8[..., k], torch.full_like(
        c8[..., k], float("-inf"))).max() for k in range(3)]
    ok = ((point_mask >= 0.5) & (nlz <= 0)
          & (d2.min(dim=1).values <= max_dist_sq))
    for k in range(3):
        ok = ok & (points[:, k] >= lo[k]) & (points[:, k] <= hi[k])
    inside = inside & ok[:, None]
    first = inside.to(torch.uint8).argmax(dim=1)
    return torch.where(inside.any(dim=1), first, torch.full_like(first, -1))


def dense_targets(points: torch.Tensor, csa: torch.Tensor,
                  gt_class: torch.Tensor, assignment: torch.Tensor,
                  label_set: Sequence[int],
                  reg_dim_weights: Sequence[float]):
    """-> reg target (N, 8K), per-dim weight (N, 8K), normalizer (N, 8K):
    each point's row in its class's slot of K."""
    N, M = points.shape[0], csa.shape[0]
    K = len(label_set)
    hit = assignment >= 0
    idx = assignment.clamp(min=0)
    box = csa[idx]
    counts = torch.zeros(M, device=points.device).index_add_(
        0, idx, hit.float())
    azimuth = torch.atan2(points[:, 1], points[:, 0])
    cos_a, sin_a = torch.cos(azimuth), torch.sin(azimuth)
    dx, dy = box[:, 0] - points[:, 0], box[:, 1] - points[:, 1]
    ox = cos_a * dx + sin_a * dy
    oy = -sin_a * dx + cos_a * dy
    dyaw = box[:, 6] - azimuth

    def log(v):
        return torch.log(v.clamp(min=1e-6))

    tgt = torch.stack([torch.sqrt(ox.abs()) * torch.sign(ox),
                       torch.sqrt(oy.abs()) * torch.sign(oy),
                       log(box[:, 4]), log(box[:, 3]), torch.cos(dyaw),
                       torch.sin(dyaw), box[:, 2] - box[:, 5] / 2.0,
                       log(box[:, 5])], dim=1)
    dims = len(reg_dim_weights)
    wdim = torch.tensor(reg_dim_weights, device=points.device)[None].expand(
        N, dims)
    norm = (1.0 / counts[idx].clamp(min=1.0))[:, None].expand(N, dims)
    label = torch.zeros(8, dtype=torch.long, device=points.device)
    for i, lab in enumerate(label_set):
        label[lab] = i
    cls = label[gt_class.long().clamp(0, 7)][idx]
    slot = (cls[:, None] == torch.arange(K, device=points.device)[None]) & \
        hit[:, None]  # (N, K)

    def expand(v):
        return (slot[:, :, None].float() * v[:, None, :]).reshape(N, K * dims)

    return expand(tgt), expand(wdim), expand(norm)


def stride_slice(x: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """Every s-th column from s // 2 (the reference's phase)."""
    if s == 1:
        return x
    index = [slice(None)] * x.dim()
    index[axis] = slice(s // 2, None, s)
    return x[tuple(index)]


def build_targets(batch: Dict[str, torch.Tensor], rc: dict
                  ) -> Dict[str, torch.Tensor]:
    """Per stride s of ``rc["fpn_strides"]``: reg_target_s, reg_weight_s,
    reg_norm_weight_s (B, H, W_s, 8K), mask_s (B, H, W_s, 1), pc_s
    (B, H, W_s, 3); and gt_corners_cls{k} (B, M, 4, 2), class k's valid
    boxes (the others zero). ``rc``: the recipe's numbers (see
    ``reference.recipe``)."""
    strides = rc["fpn_strides"]
    out = {k: [] for s in strides for k in (
        f"reg_target_s{s}", f"reg_weight_s{s}", f"reg_norm_weight_s{s}",
        f"mask_s{s}", f"pc_s{s}")}
    nlz_all = batch.get("is_in_nlz")
    for b in range(batch["pc"].shape[0]):
        pc, mask = batch["pc"][b].float(), batch["mask"][b].float()
        H, W = pc.shape[:2]
        csa = batch["gt_csa"][b].float()
        nlz = (nlz_all[b].reshape(-1) if nlz_all is not None
               else torch.full((H * W,), -1.0, device=pc.device))
        a = assign(pc.reshape(-1, 3), csa, mask.reshape(-1),
                   batch["gt_valid"][b].float(), nlz, rc["assign_radius_sq"],
                   rc["assign_max_dist_sq"])
        tgt, wdim, norm = dense_targets(pc.reshape(-1, 3), csa,
                                        batch["gt_class"][b], a,
                                        rc["label_set"],
                                        rc["reg_dim_weights"])
        rng = batch["unnorm_range"][b].float()
        for s in strides:
            lo, hi = rc["fpn_intervals"][str(s)]
            m = ((rng >= lo) & (rng < hi)).float()  # (H, W, 1)
            for key, v in ((f"reg_target_s{s}", tgt),
                           (f"reg_weight_s{s}", wdim),
                           (f"reg_norm_weight_s{s}", norm)):
                out[key].append(stride_slice(v.reshape(H, W, -1) * m, s, 1))
            out[f"mask_s{s}"].append(stride_slice(mask * m, s, 1))
            out[f"pc_s{s}"].append(stride_slice(pc, s, 1))
    targets = {k: torch.stack(v) for k, v in out.items()}
    bev = corners_bev(batch["gt_csa"].float())
    for k, lab in enumerate(rc["label_set"]):
        keep = ((batch["gt_class"].long() == lab)
                & (batch["gt_valid"] > 0.5))
        targets[f"gt_corners_cls{k}"] = torch.where(
            keep[..., None, None], bev, torch.zeros_like(bev))
    return targets
