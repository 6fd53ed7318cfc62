"""Overfit probe of the PyTorch port, counterpart of
``tools/overfit_probe.py``: train the recipe's full-size path on a few
FIXED synthetic frames (``data/synthetic.py:make_batch``) and trace the
memorization AP curve. A correct train -> decode -> WNMS -> eval loop
memorizing 2 frames drives AP toward 1.0; a plateau well below that points
to a semantic or numeric fault in the path.

    python -m rangedet_tpu_torch.tools.overfit_probe \\
        [--config rangedet_veh_wo_aug_4_18e] [--frames 2] [--boxes 10] \\
        [--steps 3000] [--eval-every 500] [--log-every 100] [--lr 3e-3] \\
        [--lr-mode constant|cosine] [--optimizer adamw] \\
        [--style paint|vehicles] [--min-score 0.25] [--seed 7] \\
        [--device cuda]

Prints one JSON line a log point: step, loss, s_per_step, and at each eval
point bev_ap_05, bev_recall, ap3d_07, recall3d_07, l1_ap, l1_aph.
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Overfit probe (PyTorch)")
    p.add_argument("--config", default="rangedet_veh_wo_aug_4_18e",
                   help="recipe name or path to a recipe .py")
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--boxes", type=int, default=10)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--lr-mode", default="constant",
                   help="constant | cosine (decay over --steps)")
    p.add_argument("--optimizer", default="adamw")
    p.add_argument("--style", default="paint", help="paint | vehicles")
    p.add_argument("--min-score", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the records printed (one dict a JSON line)."""
    args = parse_args(argv)
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.data.synthetic import make_batch
    from rangedet_tpu_torch.eval.ap import average_precision, waymo_metrics
    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.train.state import create_train_state
    from rangedet_tpu_torch.train.train_step import (
        batch_to_device,
        make_train_step,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA card")
    cfg = load_config(args.config, is_train=True)
    cfg_t = load_config(args.config, is_train=False)
    cfg_t = cfg_t.replace(min_score={k: args.min_score
                                     for k in cfg_t.min_score})
    cfg = cfg.replace(optimizer=args.optimizer, base_lr=args.lr,
                      warmup_epochs=0, lr_mode=args.lr_mode,
                      auto_scale_lr=False, begin_epoch=0,
                      end_epoch=max(1, args.steps // 1000))

    batch_np = make_batch(cfg, args.frames, seed=args.seed,
                          num_boxes=args.boxes, style=args.style)
    batch = batch_to_device(batch_np, device)
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(device), cfg, 1000, seed=None)
    step = make_train_step(state, cfg)
    eval_step = make_eval_step(model, cfg_t)
    ebatch = build_eval_inputs(batch_np, cfg_t, device)
    gt_frames = [batch_np["gt_csa"][b][batch_np["gt_valid"][b] > 0]
                 for b in range(args.frames)]

    def run_eval():
        model.eval()
        try:
            out = eval_step(ebatch)["veh"]
        finally:
            model.train()
        boxes, valid = out["boxes"].cpu().numpy(), out["valid"].cpu().numpy()
        frames = []
        for b in range(args.frames):
            kept = boxes[b][valid[b]]
            frames.append(dict(det_csa=kept[:, :7], det_scores=kept[:, 7],
                               gt_csa=gt_frames[b]))
        bev = average_precision(frames, iou_thresh=0.5, mode="bev")
        d3 = average_precision(frames, iou_thresh=0.7, mode="3d")
        wod = waymo_metrics(frames, iou_thresh=0.7, mode="3d")
        return {
            "bev_ap_05": round(bev["ap"], 4),
            "bev_recall": round(bev["recall"], 4),
            "ap3d_07": round(d3["ap"], 4),
            "recall3d_07": round(d3["recall"], 4),
            "l1_ap": round(wod["L1"]["ap"], 4),
            "l1_aph": round(wod["L1"]["aph"], 4),
        }

    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    t0 = time.time()
    for step_i in range(1, args.steps + 1):
        m = step(batch)
        if step_i % args.log_every == 0:
            rec = {"step": step_i, "loss": round(float(m["total_loss"]), 4),
                   "s_per_step": round((time.time() - t0) / step_i, 3)}
            if step_i % args.eval_every == 0 or step_i == args.steps:
                rec.update(run_eval())
            emit(rec)
    emit({"done": True, "total_s": round(time.time() - t0, 1)})
    return records


if __name__ == "__main__":
    main()
