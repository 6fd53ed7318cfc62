"""In-process evaluation, counterpart of ``rangedet_tpu/eval/evaluator.py``:
run the eval step over frames and score with the standalone AP evaluator
(``eval/ap.py``), so training gets validation metrics without the offline
Waymo tooling round-trip (which ``eval/waymo_bin.py`` still provides).
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


def evaluate(
    model,
    cfg,
    frames: Iterable,
    iou_thresh=0.7,
    mode: str = "bev",
    max_frames: int = 0,
    metric: str = "ap",
    eval_step=None,
) -> Dict[str, Dict[str, float]]:
    """frames: iterable of (batch_dict, gt_by_class) where batch_dict is a
    single-frame (B=1) numpy input batch and gt_by_class maps class name ->
    either (M, 7) csa boxes or a dict {gt_csa, gt_num_points?,
    gt_difficulty?}. The model runs on the device of its parameters.

    iou_thresh: a float, or a {class: float} map (the WOD per-class
    thresholds, cfg.eval_iou_thresh) — unknown classes fall back to 0.7.

    metric="ap" returns {class: {ap, recall, precision}};
    metric="waymo" returns {class: {L1: {ap, aph, ...}, L2: {...}}} — the
    WOD-style difficulty split + heading-weighted APH (eval/ap.py).
    """
    from ..infer import build_eval_inputs, make_eval_step
    from .ap import average_precision, waymo_metrics

    if eval_step is None:
        eval_step = make_eval_step(model, cfg)
    device = next(model.parameters()).device

    per_class = {name: [] for name in cfg.class_names}
    n = 0
    for batch, gt_by_class in frames:
        out = eval_step(build_eval_inputs(batch, cfg, device))
        for name in cfg.class_names:
            boxes = out[name]["boxes"][0].cpu().numpy()
            valid = out[name]["valid"][0].cpu().numpy()
            kept = boxes[valid]
            gt = gt_by_class.get(name, np.zeros((0, 7)))
            fr = dict(det_csa=kept[:, :7], det_scores=kept[:, 7])
            if isinstance(gt, dict):
                fr["gt_csa"] = np.asarray(gt["gt_csa"])
                for key in ("gt_num_points", "gt_difficulty"):
                    if key in gt and gt[key] is not None:
                        fr[key] = np.asarray(gt[key])
            else:
                fr["gt_csa"] = np.asarray(gt)
            per_class[name].append(fr)
        n += 1
        if max_frames and n >= max_frames:
            break

    def thresh(name):
        if isinstance(iou_thresh, dict):
            return iou_thresh.get(name, 0.7)
        return iou_thresh

    if metric == "waymo":
        return {
            name: waymo_metrics(fr, iou_thresh=thresh(name), mode=mode)
            for name, fr in per_class.items()
        }
    return {
        name: average_precision(fr, iou_thresh=thresh(name), mode=mode)
        for name, fr in per_class.items()
    }
