"""Score a prediction pickle with the port's evaluator, counterpart of
``tools/evaluate_pred.py``: AP/APH at LEVEL_1/LEVEL_2 (``eval/ap.py``),
optionally the range breakdown, per class at the recipe's operating point.
One JSON line per class.

    python -m rangedet_tpu_torch.tools.evaluate_pred \
        --config rangedet_veh_wo_aug_4_18e --pred predictions_torch.pkl \
        [--iou 0.7] [--mode 3d|bev] [--buckets] [--out ap.json]
"""
from __future__ import annotations

import argparse
import json
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Score a prediction pickle")
    p.add_argument("--config", required=True,
                   help="recipe name or path to a recipe .py")
    p.add_argument("--pred", required=True,
                   help="prediction pickle from rangedet_tpu_torch.tools.test")
    p.add_argument("--iou", type=float, default=None,
                   help="override the recipe per-class operating point")
    p.add_argument("--mode", default="3d", choices=("3d", "bev"))
    p.add_argument("--buckets", action="store_true",
                   help="add the RANGE (distance-bucket) breakdown")
    p.add_argument("--out", default=None, help="also write the JSON here")
    return p.parse_args(argv)


def load_frames(pred_path, class_names, name_to_type):
    """Per class, the frames of the pickle's two dumps (annotation dict,
    then output dict) as the evaluator's frame dicts."""
    with open(pred_path, "rb") as f:
        annotations = pickle.load(f)
        outputs = pickle.load(f)
    per_class = {c: [] for c in class_names}
    for rec_id, out in outputs.items():
        anno = annotations.get(rec_id, {})
        gt_csa = np.asarray(anno.get("gt_bbox_csa",
                                     np.zeros((0, 7), np.float32)))
        gt_cls = np.asarray(anno.get("gt_class", np.zeros((0,), np.float32)))
        gt_pts = np.asarray(anno.get("points_in_box",
                                     np.zeros((0,), np.float32)))
        for c in class_names:
            det = np.asarray(out["det_xyzlwhyaws"].get(c, np.zeros((0, 8))))
            keep = gt_cls == float(name_to_type[c])
            per_class[c].append(dict(
                det_csa=det[:, :7], det_scores=det[:, 7],
                gt_csa=gt_csa[keep],
                gt_num_points=gt_pts[keep] if gt_pts.size == gt_cls.size
                else np.zeros(int(keep.sum()), np.float32),
            ))
    return per_class


def main(argv=None):
    """Returns the list of per-class records it printed."""
    args = parse_args(argv)
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.eval.ap import range_breakdown, waymo_metrics

    cfg = load_config(args.config, is_train=False)
    name_to_type = dict(zip(cfg.class_names, cfg.label_set))
    per_class = load_frames(args.pred, cfg.class_names, name_to_type)

    records = []
    for c in cfg.class_names:
        iou = args.iou if args.iou is not None else cfg.eval_iou_thresh[c]
        wod = waymo_metrics(per_class[c], iou_thresh=iou, mode=args.mode)
        rec = {
            "class": c, "iou": iou, "mode": args.mode,
            "frames": len(per_class[c]),
            "l1_ap": round(wod["L1"]["ap"], 4),
            "l1_aph": round(wod["L1"]["aph"], 4),
            "l2_ap": round(wod["L2"]["ap"], 4),
            "l2_aph": round(wod["L2"]["aph"], 4),
            "l1_recall": round(wod["L1"]["recall"], 4),
        }
        if args.buckets:
            rb = range_breakdown(per_class[c], iou_thresh=iou, mode=args.mode)
            for label, r in rb.items():
                rec[f"l1_ap_r{label}"] = round(r["ap"], 4)
        records.append(rec)
        print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return records


if __name__ == "__main__":
    main()
