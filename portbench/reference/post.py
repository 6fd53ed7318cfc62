"""Plain RangeDet post-processing (the authors' tools/test.py and the
weighted NMS of their host library, nms.h wnms_4c): per class, the masked
sigmoid scores of all levels, the top ``device_topk`` by a stable sort, the
decode, and a greedy weighted NMS, one survivor at a time. f32.

Weighted NMS: candidates in descending score order (stable). The best
candidate still alive survives; its voters are itself and the alive
candidates of BEV IoU > thresh_vote with it; it then removes every alive
candidate of IoU >= thresh, itself included. Voters whose yaw lies 0.3 rad
or more (mod 2 pi, the library's 2 * 3.1415926) from the voters' median
yaw are dropped; with two voters or fewer the median is the survivor's
yaw, and with an even count the survivor's yaw enters the sorted list
before the middle element is taken. The output row is the voters'
score-weighted mean of the 11 values [4 corners, yaw, bottom, height]
plus the survivor's score; at most ``post_nms_top_n`` rows.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .geometry import box8, box11, decode_boxes, iou_bev

YAW_REJECT = 0.3
TWO_PI = 2.0 * 3.1415926


def _median_yaw(yaw_v: torch.Tensor, yaw_i: float) -> float:
    n = yaw_v.numel()
    if n <= 2:
        return yaw_i
    s = torch.sort(yaw_v).values
    if n % 2:
        return float(s[n // 2])
    k = n // 2
    t = int((s < yaw_i).sum())
    if k < t:
        return float(s[k])
    return yaw_i if k == t else float(s[k - 1])


def weighted_nms(dets: torch.Tensor, scores: torch.Tensor,
                 valid: torch.Tensor, thresh: float, thresh_vote: float,
                 max_keep: int):
    """One frame: dets (K, 11), scores (K,), valid (K,) -> rows
    (max_keep, 12), row_valid (max_keep,)."""
    K = dets.shape[0]
    order = torch.sort(-torch.where(valid, scores, torch.full_like(
        scores, float("-inf"))), stable=True).indices
    dets, scores, alive = dets[order], scores[order], valid[order].clone()
    corners = dets[:, :8].reshape(K, 4, 2)
    rows = torch.zeros(max_keep, 12, device=dets.device)
    row_valid = torch.zeros(max_keep, dtype=torch.bool, device=dets.device)
    weights = scores.clamp(min=0.0)
    idx = torch.arange(K, device=dets.device)
    alive_host = alive.cpu()
    r = 0
    for i in range(K):
        if r >= max_keep:
            break
        if not alive_host[i]:
            continue
        iou = iou_bev(corners[i][None], corners)
        me = idx == i
        voters = (alive & (iou > thresh_vote)) | me
        kill = alive & ((iou >= thresh) | me)
        alive = alive & ~kill
        alive_host &= ~kill.cpu()
        yaw = dets[:, 8]
        med = _median_yaw(yaw[voters], float(yaw[i]))
        ok = torch.remainder((yaw - med).abs(), TWO_PI) < YAW_REJECT
        w = torch.where(voters & ok, weights, torch.zeros_like(weights))
        avg = (w[:, None] * dets).sum(0) / w.sum().clamp(min=1e-12)
        rows[r] = torch.cat([avg, scores[i:i + 1]])
        row_valid[r] = True
        r += 1
    return rows, row_valid


def run_inference(cls: List[torch.Tensor], reg: List[torch.Tensor],
                  pcs: List[torch.Tensor], masks: List[torch.Tensor],
                  rc: dict, cast=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per level logits (B, H, W_s, K), deltas (B, H, W_s, 8K), points
    (B, H, W_s, 3), masks (B, H, W_s, 1) -> {class name: {"boxes"
    (B, max_keep, 8), "valid" (B, max_keep), "truncated" (B,)}}.
    ``cast`` (the control's): the decoded candidates, their scores and the
    output rows rounded through a lower precision."""
    cast = cast or (lambda x: x)
    B, K = cls[0].shape[0], rc["num_classes"]
    scores = torch.cat([torch.sigmoid(c.float()).reshape(B, -1, K)
                        for c in cls], 1)
    deltas = torch.cat([d.float().reshape(B, -1, K, 8) for d in reg], 1)
    pc = torch.cat([p.float().reshape(B, -1, 3) for p in pcs], 1)
    mask = torch.cat([m.float().reshape(B, -1) for m in masks], 1)
    out = {}
    for k, name in enumerate(rc["class_names"]):
        topk = min(rc["device_topk"][name], rc["pre_nms_top_n"][name],
                   scores.shape[1])
        s = torch.where(mask > 0, scores[..., k], torch.zeros_like(mask))
        idx = torch.sort(-s, dim=1, stable=True).indices[:, :topk]
        top_s = torch.gather(s, 1, idx)
        top_d = torch.gather(deltas[:, :, k], 1, idx[..., None].expand(
            -1, -1, 8))
        top_p = torch.gather(pc, 1, idx[..., None].expand(-1, -1, 3))
        dets = cast(box11(decode_boxes(top_d, top_p)))
        valid = top_s > rc["min_score"][name]
        frames = [weighted_nms(dets[b], cast(top_s[b]), valid[b],
                               rc["wnms_thr_lo"], rc["wnms_thr_hi"],
                               rc["post_nms_top_n"][name]) for b in range(B)]
        out[name] = {"boxes": cast(box8(torch.stack([f[0] for f in frames]))),
                     "valid": torch.stack([f[1] for f in frames]),
                     "truncated": top_s[:, -1] > rc["min_score"][name]}
    return out
