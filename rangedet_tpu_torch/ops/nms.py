"""Weighted NMS over 11-dim dets, counterpart of the blocked form of
``rangedet_tpu/ops/nms.py:weighted_nms`` (reference host C++ wnms_4c,
nms.h:452-577).

Semantics, as in the reference:
  * candidates are processed in descending score order (stable: equal
    scores keep their input order);
  * a survivor suppresses every remaining candidate with IoU >= thresh and
    collects voters: itself plus remaining candidates with IoU >
    thresh_vote;
  * voters whose yaw is >= 0.3 rad (mod 2*pi) from the voters' median yaw
    are rejected; <= 2 voters take the survivor's yaw as the median, and an
    even count inserts the survivor's yaw before taking the middle element;
  * the output row is the score-weighted mean of the voters' 11 values plus
    the survivor's score.

Each round selects the next ``block`` alive candidates, computes their IoU
rows as one batch, resolves the greedy chain inside the block, and votes
for the whole block at once. It is exact: an IoU row does not depend on the
suppression state, and a candidate between two block members was already
dead when the block was selected. Frames run side by side; the host checks
once per round whether any frame still has work. That check is a
profiler range ``host_sync`` and each round after it ``wnms.round``
(``utils/spans.py``): a call checks once more than it has rounds, and each
round's IoU rows wait twice more (``rotated_iou._ccw``'s list index).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.spans import span
from .boxes import polygon_area
from .rotated_iou import iou_bev_corners

YAW_REJECT = 0.3
TWO_PI = 2.0 * 3.1415926  # the constant of nms.h:542


def _det_iou(dets11: torch.Tensor, one: torch.Tensor, iou_3d: bool
             ) -> torch.Tensor:
    """IoU of the block members ``one`` (F, Bk, 11) against all candidates
    ``dets11`` (F, K, 11) -> (F, Bk, K)."""
    F_, K = dets11.shape[:2]
    corners = dets11[..., :8].reshape(F_, 1, K, 4, 2)
    one_c = one[..., :8].reshape(one.shape[:2] + (1, 4, 2))
    bev = iou_bev_corners(one_c, corners)
    if not iou_3d:
        return bev
    # volumetric IoU with z extents [bottom, bottom + height] (nms.h:172-184)
    a0, h0 = one[..., 9:10], one[..., 10:11]  # (F, Bk, 1)
    a1, h1 = dets11[:, None, :, 9], dets11[:, None, :, 10]  # (F, 1, K)
    z_ov = torch.clamp(
        torch.minimum(a0 + h0, a1 + h1) - torch.maximum(a0, a1), min=0.0
    )
    s_one = polygon_area(one_c).abs()
    s_all = polygon_area(corners).abs()
    inter = bev * (s_one + s_all) / (1.0 + bev) * z_ov
    union = s_one * h0 + s_all * h1 - inter
    return inter / torch.clamp(union, min=1e-8)


def _median_yaw_presorted(voters_sorted, yaw_sorted, yaw_i):
    """Median voter yaw with the reference's tie-breaks (nms.h:527-540),
    from the voter mask and yaws in ascending-yaw order. Leading dims
    broadcast; the last is the candidate axis."""
    c = torch.cumsum(voters_sorted.to(torch.int32), dim=-1)
    n = c[..., -1]

    def pick(rank):  # 0-based rank among voters, in yaw order
        sel = voters_sorted & (c == (rank + 1)[..., None])
        return torch.where(sel, yaw_sorted, torch.zeros_like(yaw_sorted)
                           ).sum(dim=-1)

    odd_median = pick(n // 2)
    t = (voters_sorted & (yaw_sorted < yaw_i[..., None])).sum(dim=-1)
    k = n // 2
    even_median = torch.where(
        k < t, pick(k), torch.where(k == t, yaw_i, pick(k - 1))
    )
    median = torch.where(n % 2 == 1, odd_median, even_median)
    return torch.where(n <= 2, yaw_i, median)


def weighted_nms(
    dets11: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    thresh: float,
    thresh_vote: float,
    max_keep: int,
    iou_3d: bool = False,
    block: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted NMS of (F, K, 11) dets [8 corners, yaw, bottom, height] with
    (F, K) scores and validity, F frames at once; (K, 11) runs one frame.

    Returns out12 (F, max_keep, 12) [weighted 11 values, survivor score] and
    out_valid (F, max_keep), without F for a single frame.
    """
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    single = dets11.dim() == 2
    if single:
        dets11, scores, valid = dets11[None], scores[None], valid[None]
    F_, K = scores.shape
    dev = dets11.device
    dets11 = dets11.float()
    neg_inf = torch.full_like(scores, float("-inf"), dtype=torch.float32)
    scores = torch.where(valid, scores.float(), neg_inf)

    order = torch.sort(-scores, dim=-1, stable=True).indices
    dets11 = torch.gather(dets11, 1, order[..., None].expand(-1, -1, 11))
    scores = torch.gather(scores, 1, order)
    valid = torch.gather(valid, 1, order)
    yaw = dets11[..., 8]
    yaw_order = torch.sort(yaw, dim=-1, stable=True).indices
    yaw_sorted = torch.gather(yaw, 1, yaw_order)
    arange = torch.arange(K, device=dev)
    weights = torch.clamp(scores, min=0.0)
    Bk = min(block, K)

    suppressed = ~valid
    rows = torch.zeros((F_, max_keep + 1, 12), device=dev)  # last: dump slot
    row_valid = torch.zeros((F_, max_keep + 1), dtype=torch.bool, device=dev)
    r = torch.zeros((F_,), dtype=torch.long, device=dev)
    while True:
        alive0 = valid & ~suppressed
        active = (r < max_keep) & alive0.any(dim=-1)
        with span("host_sync"):
            more = bool(active.any())
        if not more:
            break
        with span("wnms.round"):
            # the next Bk alive candidates in score order
            key = torch.where(alive0, arange, torch.full_like(arange, K))
            key_sorted, sub = torch.sort(key, dim=-1, stable=True)
            sub = sub[:, :Bk]
            sub_ok = (key_sorted[:, :Bk] < K) & active[:, None]
            one = torch.gather(dets11, 1, sub[..., None].expand(-1, -1, 11))
            iou_blk = _det_iou(dets11, one, iou_3d)  # (F, Bk, K)
            is_member = arange == sub[..., None]  # (F, Bk, K)

            # pass 1: the in-block greedy chain
            kill = torch.zeros_like(alive0)
            surv_l, alive_at_l = [], []
            for b in range(Bk):
                alive_b = alive0 & ~kill
                alive_at_l.append(alive_b)
                s_b = sub_ok[:, b] & torch.gather(
                    alive_b, 1, sub[:, b:b + 1])[:, 0]
                surv_l.append(s_b)
                kill = kill | (s_b[:, None] & (
                    (iou_blk[:, b] >= thresh) | is_member[:, b]))
            surv = torch.stack(surv_l, dim=1)  # (F, Bk)
            alive_at = torch.stack(alive_at_l, dim=1)  # (F, Bk, K)

            # pass 2: voting, median yaw and weighted mean for the whole block
            voters = (alive_at & (iou_blk > thresh_vote)) | is_member
            yaw_i = torch.gather(yaw, 1, sub)
            median = _median_yaw_presorted(
                torch.gather(voters, 2, yaw_order[:, None].expand(-1, Bk, -1)),
                yaw_sorted[:, None], yaw_i,
            )
            yaw_ok = torch.remainder(
                (yaw[:, None] - median[..., None]).abs(), TWO_PI
            ) < YAW_REJECT
            w = torch.where(voters & yaw_ok, weights[:, None],
                            torch.zeros_like(iou_blk))
            wsum = torch.clamp(w.sum(dim=-1), min=1e-12)
            avg11 = ((w[..., None] * dets11[:, None]).sum(dim=2)
                     / wsum[..., None])
            blk_rows = torch.cat(
                [avg11, torch.gather(scores, 1, sub)[..., None]], dim=-1
            )

            # emit survivors at their greedy ranks; the rest go to the dump
            # slot
            ranks = r[:, None] + torch.cumsum(surv.long(), dim=-1) - 1
            slot = torch.where(surv, ranks, torch.full_like(ranks, max_keep))
            slot = torch.clamp(slot, max=max_keep)
            rows.scatter_(1, slot[..., None].expand(-1, -1, 12), blk_rows)
            row_valid.scatter_(1, slot, torch.ones_like(surv))
            suppressed = suppressed | kill
            r = torch.clamp(r + surv.sum(dim=-1), max=max_keep)

    rows, row_valid = rows[:, :max_keep], row_valid[:, :max_keep]
    if single:
        return rows[0], row_valid[0]
    return rows, row_valid


def nms_3d(boxes10: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
           iou_thresh: float, max_keep: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over box10 dets, the reference's contrib.NMS3D
    (nms_3d.cu:380-534, used when a config sets wnms=False), as
    ``rangedet_tpu/ops/nms.py:nms_3d``: max_keep rounds, each keeping the
    best-scored box still alive and suppressing the alive boxes of BEV IoU
    >= iou_thresh with it. -> (keep_boxes (max_keep, 10), keep_idx
    (max_keep,) positions in the input order, -1 past the kept, valid
    (max_keep,)). The order is a stable sort of the scores, descending."""
    K = boxes10.shape[0]
    order = torch.sort(-scores.float().masked_fill(~valid, -float("inf")),
                       stable=True).indices
    boxes10 = boxes10[order]
    svalid = valid[order]
    corners = boxes10[:, :8].reshape(-1, 4, 2)
    arange = torch.arange(K, device=boxes10.device)
    suppressed = ~svalid
    kept = boxes10.new_zeros((max_keep, 10))
    keep_idx = torch.full((max_keep,), -1, dtype=torch.long,
                          device=boxes10.device)
    row_valid = torch.zeros((max_keep,), dtype=torch.bool,
                            device=boxes10.device)
    for r in range(max_keep):
        alive = svalid & ~suppressed
        has_any = alive.any()
        idx = torch.argmax(alive.to(torch.uint8))
        iou_row = iou_bev_corners(corners[idx][None], corners)
        new = suppressed | (alive & (iou_row >= iou_thresh)) | (arange == idx)
        suppressed = torch.where(has_any, new, suppressed)
        kept[r] = torch.where(has_any, boxes10[idx], kept[r])
        keep_idx[r] = torch.where(has_any, order[idx], keep_idx[r])
        row_valid[r] = has_any
    return kept, keep_idx, row_valid
