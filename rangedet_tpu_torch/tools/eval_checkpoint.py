"""Score a saved checkpoint of the port at several operating points,
counterpart of ``tools/eval_checkpoint.py``.

The deploy-time score threshold (cfg.min_score) filters candidates before
the WNMS, so an undertrained checkpoint can report AP 0 at the shipped
operating point while already ranking true boxes above noise at a looser
one. This CLI restores the latest (or the chosen) checkpoint of an
experiment directory and prints one JSON line of the in-training
validation metric (``tools/train.py:build_validation``: 3D IoU at the
WOD operating points) per (min_score, iou):

    python -m rangedet_tpu_torch.tools.eval_checkpoint \
        --config rangedet_veh_wo_aug_4_18e --experiment-dir DIR \
        [--data-root DIR | --synthetic] [--epoch N] \
        [--min-scores 0.5,0.25,0.1] [--ious 0.7,0.5] [--n-frames 8] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Score a checkpoint (PyTorch)")
    p.add_argument("--config", required=True,
                   help="recipe name or path to a recipe .py")
    p.add_argument("--experiment-dir", default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch (default: latest)")
    p.add_argument("--min-scores", default="0.5,0.25,0.1")
    p.add_argument("--ious", default=None,
                   help="comma list; default: the config's per-class points")
    p.add_argument("--n-frames", type=int, default=8)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the records it printed; exits 1 without a checkpoint."""
    args = parse_args(argv)
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.tools.train import build_validation
    from rangedet_tpu_torch.train.checkpoint import restore_checkpoint

    cfg = load_config(args.config, is_train=True)
    if args.data_root:
        cfg = cfg.replace(data_root=args.data_root)
    if args.experiment_dir:
        cfg = cfg.replace(experiment_dir=args.experiment_dir)
    model = RangeDet(**cfg.model_kwargs()).to(torch.device(args.device))
    _, ep = restore_checkpoint(model, cfg, args.epoch)
    if ep is None:
        print(json.dumps({"error": "no checkpoint found"}))
        raise SystemExit(1)

    ious = ([float(x) for x in args.ious.split(",")]
            if args.ious else [None])
    records = []
    for ms in (float(x) for x in args.min_scores.split(",")):
        for iou in ious:
            c = cfg.replace(min_score={k: ms for k in cfg.min_score})
            if iou is not None:
                c = c.replace(
                    eval_iou_thresh={k: iou for k in c.eval_iou_thresh})
            m = build_validation(model, c, args.synthetic, cfg.data_root,
                                 n_frames=args.n_frames)()
            rec = {"epoch": ep, "min_score": ms,
                   "iou": iou or c.eval_iou_thresh,
                   "metrics": {cls: {k: round(float(v), 4)
                                     for k, v in d.items()}
                               for cls, d in m.items()}}
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
