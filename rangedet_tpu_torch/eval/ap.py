"""Standalone BEV/3D average-precision evaluation with WOD-style APH and
LEVEL_1 / LEVEL_2 difficulty splits: the port's copy of
``rangedet_tpu/eval/ap.py``, line for line but the pairwise IoU, which runs
the port's own rotated-IoU ops on the CPU.

The reference relies entirely on the offline Waymo evaluator (`metrics_pb2`
bins + the WOD tooling, tools/create_prediction_bin_3d.py:26-75). That
dependency is preserved via eval/waymo_bin.py, but the framework also ships
its own evaluator so the published targets (e.g. Veh L1 3D AP 70.1,
reference README.md:73-76) are measurable anywhere (KITTI, synthetic, CI)
without the gated proto path:

  * AP: greedy score-ordered matching at an IoU threshold + 101-point
    interpolated AP (the WOD evaluator uses Hungarian matching; greedy is
    the standard COCO/KITTI approximation and matches it on well-separated
    detections). :func:`waymo_metrics_hungarian` implements the WOD
    construction itself (score-cutoff sweep + Hungarian assignment per
    cutoff); tests/test_ap.py bounds the greedy−Hungarian |ΔAP| on crowded
    scenes;
  * APH: every true positive is weighted by heading accuracy
    1 − |Δyaw_wrapped| / π, exactly the WOD definition;
  * L1/L2: a GT box is LEVEL_2 when the labeler marked it so or it contains
    ≤ 5 lidar points; boxes with 0 points are excluded entirely. LEVEL_1
    metrics score L1 GTs only — detections overlapping an L2 ("ignore") GT
    are dropped rather than counted as false positives; LEVEL_2 metrics
    score all non-empty GTs.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _iou_matrix_np(det_csa: np.ndarray, gt_csa: np.ndarray, mode: str) -> np.ndarray:
    """Pairwise det×gt IoU for the host-side evaluator, in f32 on the CPU:
    the candidate-vertex formulation of ``ops/rotated_iou.py`` (boundary-
    inclusive and stable on exactly colinear edges, i.e. identical or
    touching boxes, where the train graph's clip form is chaotic)."""
    import torch

    from ..ops import boxes as ops_boxes
    from ..ops import rotated_iou as ops_iou

    nd, ng = len(det_csa), len(gt_csa)
    if nd == 0 or ng == 0:
        return np.zeros((nd, ng), np.float32)
    a = torch.from_numpy(np.asarray(det_csa, np.float32))
    b = torch.from_numpy(np.asarray(gt_csa, np.float32))
    with torch.no_grad():
        if mode == "bev":
            out = ops_iou.iou_bev_matrix_robust(
                ops_boxes.csa_to_corners_bev(a), ops_boxes.csa_to_corners_bev(b))
        else:
            out = ops_iou.iou_3d_csa_robust(a[:, None, :], b[None, :, :])
    return out.numpy()


def match_frame(
    det_csa: np.ndarray,
    det_scores: np.ndarray,
    gt_csa: np.ndarray,
    iou_thresh: float,
    mode: str = "3d",
) -> Tuple[np.ndarray, int]:
    """Greedy matching in score order. Returns (tp flags per det, num_gt)."""
    order = np.argsort(-det_scores)
    iou = _iou_matrix_np(det_csa[order], gt_csa, mode)
    matched = np.zeros(len(gt_csa), bool)
    tp = np.zeros(len(det_csa), bool)
    for i in range(len(det_csa)):
        if len(gt_csa) == 0:
            break
        row = np.where(matched, -1.0, iou[i])
        j = int(np.argmax(row))
        if row[j] >= iou_thresh:
            matched[j] = True
            tp[i] = True
    # un-permute
    out = np.zeros_like(tp)
    out[order] = tp
    return out, len(gt_csa)


def heading_accuracy(det_yaw: np.ndarray, gt_yaw: np.ndarray) -> np.ndarray:
    """WOD heading-accuracy weight: 1 − min(|Δ| mod 2π, 2π − |Δ| mod 2π)/π."""
    d = np.abs(np.asarray(det_yaw) - np.asarray(gt_yaw)) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    return 1.0 - d / np.pi


def gt_difficulty(
    num_points: np.ndarray, manual_difficulty: np.ndarray | None = None
) -> np.ndarray:
    """Per-GT level: 0 = excluded (empty box), 1 = LEVEL_1, 2 = LEVEL_2.

    WOD rule: a manual (labeler) difficulty, when set (nonzero), is used
    directly — including an explicit LEVEL_1 on a sparse box; the ≤ 5
    lidar-points → LEVEL_2 fallback applies only where the manual difficulty
    is UNKNOWN (0 / absent). 0 points → not evaluated at all.
    """
    num_points = np.asarray(num_points).reshape(-1)
    level = np.where(num_points <= 5, 2, 1)
    if manual_difficulty is not None:
        manual = np.asarray(manual_difficulty).reshape(-1).astype(np.int32)
        level = np.where(manual > 0, manual, level)
    return np.where(num_points == 0, 0, level).astype(np.int32)


def _match_frame_full(
    det_csa: np.ndarray,
    det_scores: np.ndarray,
    gt_csa: np.ndarray,
    gt_keep: np.ndarray,
    gt_ignore: np.ndarray,
    iou_thresh: float,
    mode: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Greedy matching against the kept GTs, with an ignore set.

    Returns (tp, hweight, drop, num_gt): per-det TP flag, per-det heading
    weight (1 for FPs — only TPs are weighted), per-det drop flag (matched an
    ignored GT: excluded from the PR curve), and the kept-GT count.
    """
    det_csa = det_csa.reshape(-1, 7)
    gt_csa = gt_csa.reshape(-1, 7)
    n_det = len(det_csa)
    order = np.argsort(-det_scores)
    iou = _iou_matrix_np(det_csa[order], gt_csa, mode)
    matched = np.zeros(len(gt_csa), bool)
    tp = np.zeros(n_det, bool)
    hw = np.ones(n_det, np.float64)
    drop = np.zeros(n_det, bool)
    for i in range(n_det):
        if len(gt_csa) == 0:
            break
        row = np.where(matched | ~gt_keep, -1.0, iou[i])
        j = int(np.argmax(row)) if len(row) else 0
        if len(row) and row[j] >= iou_thresh:
            matched[j] = True
            tp[i] = True
            hw[i] = heading_accuracy(det_csa[order[i], 6], gt_csa[j, 6])
        else:
            # unmatched: drop instead of FP when it overlaps an ignored GT
            irow = np.where(gt_ignore, iou[i], -1.0)
            if len(irow) and irow.max() >= iou_thresh:
                drop[i] = True
    out_tp = np.zeros_like(tp)
    out_hw = np.ones_like(hw)
    out_drop = np.zeros_like(drop)
    out_tp[order], out_hw[order], out_drop[order] = tp, hw, drop
    return out_tp, out_hw, out_drop, int(gt_keep.sum())


def _pr_summary(scores, tps, hws, total_gt) -> Dict[str, float]:
    """101-point interpolated AP and APH from pooled detections."""
    if total_gt == 0 or len(scores) == 0:
        return {"ap": 0.0, "aph": 0.0, "recall": 0.0, "precision": 0.0}
    order = np.argsort(-scores)
    tps, hws = tps[order], hws[order]
    cum_tp = np.cumsum(tps)
    cum_fp = np.cumsum(~tps)
    cum_h = np.cumsum(np.where(tps, hws, 0.0))
    recall = cum_tp / total_gt
    denom = np.maximum(cum_tp + cum_fp, 1)
    precision = cum_tp / denom
    precision_h = cum_h / denom  # heading-weighted precision (WOD APH)

    ap = aph = 0.0
    for r in np.linspace(0, 1, 101):
        sel = recall >= r
        ap += (precision[sel].max() if sel.any() else 0.0) / 101.0
        aph += (precision_h[sel].max() if sel.any() else 0.0) / 101.0
    return {
        "ap": float(ap),
        "aph": float(aph),
        "recall": float(recall[-1]) if len(recall) else 0.0,
        "precision": float(precision[-1]) if len(precision) else 0.0,
    }


def _frame_level(fr, gt_csa):
    if "gt_num_points" in fr:
        return gt_difficulty(fr["gt_num_points"], fr.get("gt_difficulty"))
    return np.ones(len(gt_csa), np.int32)


def waymo_metrics_hungarian(
    frames: Sequence[Dict[str, np.ndarray]],
    iou_thresh: float = 0.7,
    mode: str = "3d",
    num_cutoffs: int = 201,
) -> Dict[str, Dict[str, float]]:
    """WOD-construction reference evaluator: sweep score cutoffs and
    Hungarian-match detections to GTs (max total IoU among pairs with
    IoU ≥ thresh) at each cutoff — the matching the official WOD evaluator
    uses. Slower than :func:`waymo_metrics` (one assignment solve per frame
    per cutoff); used to bound the greedy approximation (tests/test_ap.py)
    and available for final numbers.
    """
    from scipy.optimize import linear_sum_assignment

    cutoffs = np.linspace(0.0, 1.0, num_cutoffs)
    # per level: tp, tp_h (heading-weighted), n_det (after ignore-drop), per cutoff
    acc = {
        name: {"tp": np.zeros(num_cutoffs), "tph": np.zeros(num_cutoffs),
               "det": np.zeros(num_cutoffs), "gt": 0}
        for name in ("L1", "L2")
    }
    for fr in frames:
        det_csa = np.asarray(fr["det_csa"], np.float32).reshape(-1, 7)
        det_scores = np.asarray(fr["det_scores"], np.float32).reshape(-1)
        gt_csa = np.asarray(fr["gt_csa"], np.float32).reshape(-1, 7)
        level = _frame_level(fr, gt_csa)
        iou_full = _iou_matrix_np(det_csa, gt_csa, mode)
        for name, keep, ignore in (
            ("L1", level == 1, level != 1),
            ("L2", level >= 1, level == 0),
        ):
            acc[name]["gt"] += int(keep.sum())
            iou = iou_full[:, keep] if keep.any() else np.zeros(
                (len(det_csa), 0), np.float32)
            iou_ign = iou_full[:, ignore] if ignore.any() else None
            gt_yaw = gt_csa[keep, 6]
            for ci, c in enumerate(cutoffs):
                sel = det_scores >= c
                n_sel = int(sel.sum())
                if n_sel == 0:
                    continue
                sub = iou[sel]
                tp = tph = 0.0
                matched_det = np.zeros(n_sel, bool)
                if sub.size:
                    cost = np.where(sub >= iou_thresh, -sub, 1.0)
                    ri, gi = linear_sum_assignment(cost)
                    ok = sub[ri, gi] >= iou_thresh
                    tp = float(ok.sum())
                    hw = heading_accuracy(
                        det_csa[sel][ri[ok], 6], gt_yaw[gi[ok]]
                    )
                    tph = float(hw.sum())
                    matched_det[ri[ok]] = True
                # unmatched dets overlapping an ignored GT are dropped
                n_drop = 0
                if iou_ign is not None and iou_ign.shape[1]:
                    overlaps_ign = iou_ign[sel].max(axis=1) >= iou_thresh
                    n_drop = int((overlaps_ign & ~matched_det).sum())
                acc[name]["tp"][ci] += tp
                acc[name]["tph"][ci] += tph
                acc[name]["det"][ci] += n_sel - n_drop
    out = {}
    for name, a in acc.items():
        if a["gt"] == 0:
            out[name] = {"ap": 0.0, "aph": 0.0, "recall": 0.0, "precision": 0.0}
            continue
        recall = a["tp"] / a["gt"]
        denom = np.maximum(a["det"], 1)
        precision = a["tp"] / denom
        precision_h = a["tph"] / denom
        ap = aph = 0.0
        for r in np.linspace(0, 1, 101):
            selr = recall >= r
            ap += (precision[selr].max() if selr.any() else 0.0) / 101.0
            aph += (precision_h[selr].max() if selr.any() else 0.0) / 101.0
        out[name] = {
            "ap": float(ap),
            "aph": float(aph),
            "recall": float(recall.max()),
            "precision": float(precision[0]) if len(precision) else 0.0,
        }
    return out


def waymo_metrics(
    frames: Sequence[Dict[str, np.ndarray]],
    iou_thresh: float = 0.7,
    mode: str = "3d",
) -> Dict[str, Dict[str, float]]:
    """WOD-style L1/L2 3D-AP and APH over a frame list.

    Each frame dict carries det_csa (N,7), det_scores (N,), gt_csa (M,7) and
    optionally gt_num_points (M,) and gt_difficulty (M,) (labeler levels).
    Without gt_num_points every GT is treated as LEVEL_1 with points, making
    L1 == L2 == plain AP/APH.
    """
    pools = {
        "L1": {"scores": [], "tp": [], "hw": [], "gt": 0},
        "L2": {"scores": [], "tp": [], "hw": [], "gt": 0},
    }
    for fr in frames:
        det_csa = np.asarray(fr["det_csa"], np.float32).reshape(-1, 7)
        det_scores = np.asarray(fr["det_scores"], np.float32).reshape(-1)
        gt_csa = np.asarray(fr["gt_csa"], np.float32).reshape(-1, 7)
        level = _frame_level(fr, gt_csa)

        for name, keep, ignore in (
            ("L1", level == 1, level != 1),  # L2 and empty GTs ignored
            ("L2", level >= 1, level == 0),  # only empty GTs ignored
        ):
            tp, hw, drop, n_gt = _match_frame_full(
                det_csa, det_scores, gt_csa, keep, ignore, iou_thresh, mode
            )
            pool = pools[name]
            pool["scores"].append(det_scores[~drop])
            pool["tp"].append(tp[~drop])
            pool["hw"].append(hw[~drop])
            pool["gt"] += n_gt

    out = {}
    for name, pool in pools.items():
        scores = (
            np.concatenate(pool["scores"]) if pool["scores"] else np.zeros(0)
        )
        tps = np.concatenate(pool["tp"]) if pool["tp"] else np.zeros(0, bool)
        hws = np.concatenate(pool["hw"]) if pool["hw"] else np.zeros(0)
        out[name] = _pr_summary(scores, tps, hws, pool["gt"])
    return out


#: WOD RANGE breakdown buckets (meters of box-center XY distance) — the
#: official tool's [0, 30) / [30, 50) / [50, +inf) generator
RANGE_BUCKETS = ((0.0, 30.0), (30.0, 50.0), (50.0, float("inf")))


def range_breakdown(
    frames: Sequence[Dict[str, np.ndarray]],
    iou_thresh: float = 0.7,
    mode: str = "3d",
    buckets: Sequence[Tuple[float, float]] = RANGE_BUCKETS,
    level: str = "L1",
) -> Dict[str, Dict[str, float]]:
    """WOD-style RANGE breakdown: AP/APH per center-distance bucket.

    Per bucket, GTs of the requested difficulty level whose XY center
    distance falls in [lo, hi) are scored; all other GTs are ignore-set
    (detections matching them drop from the PR pool, as in the L1/L2
    split), and unmatched detections whose own center lies outside the
    bucket are excluded rather than counted as this bucket's FPs — the
    official breakdown assigns FPs by detection range.
    """
    out: Dict[str, Dict[str, float]] = {}
    for lo, hi in buckets:
        scores_l, tp_l, hw_l = [], [], []
        n_gt = 0
        for fr in frames:
            det_csa = np.asarray(fr["det_csa"], np.float32).reshape(-1, 7)
            det_scores = np.asarray(fr["det_scores"], np.float32).reshape(-1)
            gt_csa = np.asarray(fr["gt_csa"], np.float32).reshape(-1, 7)
            lvl = _frame_level(fr, gt_csa)
            lvl_keep = lvl == 1 if level == "L1" else lvl >= 1
            gt_r = np.hypot(gt_csa[:, 0], gt_csa[:, 1])
            in_b = (gt_r >= lo) & (gt_r < hi)
            keep = lvl_keep & in_b
            ignore = ~keep & (lvl != 0)  # other buckets/levels: ignore
            tp, hw, drop, m = _match_frame_full(
                det_csa, det_scores, gt_csa, keep, ignore, iou_thresh, mode
            )
            det_r = np.hypot(det_csa[:, 0], det_csa[:, 1])
            det_out = (det_r < lo) | (det_r >= hi)
            drop = drop | (~tp & det_out)
            scores_l.append(det_scores[~drop])
            tp_l.append(tp[~drop])
            hw_l.append(hw[~drop])
            n_gt += m
        scores = np.concatenate(scores_l) if scores_l else np.zeros(0)
        tps = np.concatenate(tp_l) if tp_l else np.zeros(0, bool)
        hws = np.concatenate(hw_l) if hw_l else np.zeros(0)
        label = f"[{lo:g}, {hi:g})"
        out[label] = _pr_summary(scores, tps, hws, n_gt)
    return out


def average_precision(
    frames: Sequence[Dict[str, np.ndarray]],
    iou_thresh: float = 0.7,
    mode: str = "3d",
) -> Dict[str, float]:
    """frames: list of dicts with det_csa (N,7), det_scores (N,), gt_csa (M,7).

    Returns {"ap": 101-pt interpolated AP, "recall": max recall,
    "precision": precision at max recall}.
    """
    all_scores: List[np.ndarray] = []
    all_tp: List[np.ndarray] = []
    total_gt = 0
    for fr in frames:
        tp, n_gt = match_frame(
            np.asarray(fr["det_csa"], np.float32).reshape(-1, 7),
            np.asarray(fr["det_scores"], np.float32).reshape(-1),
            np.asarray(fr["gt_csa"], np.float32).reshape(-1, 7),
            iou_thresh,
            mode,
        )
        all_scores.append(np.asarray(fr["det_scores"]).reshape(-1))
        all_tp.append(tp)
        total_gt += n_gt

    if total_gt == 0 or not all_scores:
        return {"ap": 0.0, "recall": 0.0, "precision": 0.0}

    scores = np.concatenate(all_scores)
    tps = np.concatenate(all_tp)
    order = np.argsort(-scores)
    tps = tps[order]
    cum_tp = np.cumsum(tps)
    cum_fp = np.cumsum(~tps)
    recall = cum_tp / total_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)

    # 101-point interpolation
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        p = precision[recall >= r].max() if (recall >= r).any() else 0.0
        ap += p / 101.0
    return {
        "ap": float(ap),
        "recall": float(recall[-1]) if len(recall) else 0.0,
        "precision": float(precision[-1]) if len(precision) else 0.0,
    }
