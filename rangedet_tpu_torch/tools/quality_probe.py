"""Held-out quality probe of the PyTorch port, counterpart of
``tools/quality_probe.py``: train the recipe's full-size path on a fresh
raytraced scene every step, rendered on the card
(``data/synthetic_device.py``), and score held-out scenes with the
WOD-style evaluator (``eval/ap.py``) at the recipe's operating point.

    python -m rangedet_tpu_torch.tools.quality_probe \\
        [--config rangedet_veh_wo_aug_4_18e] [--steps 6000] \\
        [--eval-every 1000] [--log-every 200] [--batch B] [--boxes 10] \\
        [--far] [--clutter N] [--holdout-frames 16] [--eval-batch 4] \\
        [--lr 1e-3] [--optimizer adamw] [--warmup-steps 500] \\
        [--min-score 0.25] [--seed 0] [--save FILE] [--resume FILE] \\
        [--step0 N] [--stop-after N] [--device cuda]

The step is the port's ``make_train_step``; the optimizer is
``--optimizer`` at ``--lr`` with ``--warmup-steps`` of warm-up and cosine
decay over ``--steps`` (``train/schedule.py``, epochs of 1000 steps). The
scenes of step i come from a generator seeded by (``--seed``, i +
``--step0``); the held-out scenes from the seeds HOLDOUT_SEED0 + i, one
batch of ``--eval-batch`` frames a seed. The families follow the recipe's
classes (``--far`` stretches their ranges, ``--clutter`` adds unlabeled
cuboids).

Prints one JSON line a log point (step, loss, s_per_step, the losses) and
adds, at each eval point, per class: bev_ap_05, the L1/L2 AP and APH at
the recipe's IoU, L1 AP 0.2 below it, L1 recall, and at the horizon the
RANGE buckets. The segment's last step always logs and evals.
``--stop-after N`` runs N steps of the ``--steps`` horizon (the schedule
spans all of it); ``--save`` writes the model's parameters and buffers, the
optimizer's state and the step count, ``--resume`` reads them back; with
``--stop-after 0 --resume`` the probe only rescores the saved model.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

HOLDOUT_SEED0 = 1_000_000  # train seeds are step indices; disjoint by design


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Held-out quality probe "
                                            "(PyTorch)")
    p.add_argument("--config", default="rangedet_veh_wo_aug_4_18e",
                   help="recipe name or path to a recipe .py")
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--eval-every", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--batch", type=int, default=None,
                   help="train batch size")
    p.add_argument("--boxes", type=int, default=10)
    p.add_argument("--far", action="store_true",
                   help="far-range families: vehicles out to 68 m (ped 50, "
                        "cyc 55 m)")
    p.add_argument("--clutter", type=int, default=0,
                   help="unlabeled clutter cuboids a scene")
    p.add_argument("--holdout-frames", type=int, default=16)
    p.add_argument("--eval-batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adamw")
    p.add_argument("--warmup-steps", type=int, default=500)
    p.add_argument("--min-score", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", default=None,
                   help="write the model and optimizer state here at the end")
    p.add_argument("--resume", default=None,
                   help="a file of --save to continue from")
    p.add_argument("--step0", type=int, default=0,
                   help="scene seed offset when resuming (keeps the scene "
                        "stream disjoint from the earlier segment)")
    p.add_argument("--stop-after", type=int, default=None,
                   help="run only this many steps of the --steps horizon, "
                        "then save and exit")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def scene_families(class_names, far: bool):
    """The (dims, r_range, class enum) family of each recipe class."""
    from rangedet_tpu_torch.data.synthetic_device import (
        CYC_DIMS,
        PED_DIMS,
        VEHICLE_DIMS,
    )

    family = {
        "veh": (VEHICLE_DIMS, (8.0, 50.0), 1.0),
        "ped": (PED_DIMS, (5.0, 35.0), 2.0),
        "cyc": (CYC_DIMS, (5.0, 40.0), 4.0),
    }
    if far:
        # stretch each family into the far field (the range-conditioned
        # pyramid assigns 30-100 m to stride 1)
        far_hi = {"veh": 68.0, "ped": 50.0, "cyc": 55.0}
        family = {c: (d, (rr[0], far_hi[c]), v)
                  for c, (d, rr, v) in family.items()}
    return tuple(family[c] for c in class_names)


def score(outs, holdout, cfg_t, families, buckets: bool):
    """{metric: value} of the eval outputs ``outs`` (one per held-out
    batch, on the host) against the held-out GT."""
    from rangedet_tpu_torch.eval.ap import (
        average_precision,
        range_breakdown,
        waymo_metrics,
    )

    names = cfg_t.class_names
    enum_of = {c: f[2] for c, f in zip(names, families)}
    per_class = {c: [] for c in names}
    for hb, out in zip(holdout, outs):
        for b in range(hb["gt_valid"].shape[0]):
            for c in names:
                kept = out[c]["boxes"][b][out[c]["valid"][b]]
                keep_gt = (hb["gt_valid"][b] > 0) & (
                    hb["gt_class"][b] == enum_of[c])
                per_class[c].append(dict(
                    det_csa=kept[:, :7], det_scores=kept[:, 7],
                    gt_csa=hb["gt_csa"][b][keep_gt],
                    gt_num_points=hb["gt_num_points"][b][keep_gt]))
    rec = {}
    multi = len(names) > 1
    for c in names:
        frames = per_class[c]
        # the recipe's operating point (veh 0.7, ped and cyc 0.5) and 0.2
        # below it
        iou_op = cfg_t.eval_iou_thresh[c]
        iou_lo = round(iou_op - 0.2, 1)
        s_op = f"{int(round(iou_op * 10)):02d}"
        s_lo = f"{int(round(iou_lo * 10)):02d}"
        p = f"{c}_" if multi else ""
        bev = average_precision(frames, iou_thresh=0.5, mode="bev")
        wod_op = waymo_metrics(frames, iou_thresh=iou_op, mode="3d")
        wod_lo = waymo_metrics(frames, iou_thresh=iou_lo, mode="3d")
        rec.update({
            f"{p}bev_ap_05": round(bev["ap"], 4),
            f"{p}l1_ap_{s_op}": round(wod_op["L1"]["ap"], 4),
            f"{p}l1_aph_{s_op}": round(wod_op["L1"]["aph"], 4),
            f"{p}l2_ap_{s_op}": round(wod_op["L2"]["ap"], 4),
            f"{p}l2_aph_{s_op}": round(wod_op["L2"]["aph"], 4),
            f"{p}l1_ap_{s_lo}": round(wod_lo["L1"]["ap"], 4),
            f"{p}l1_recall_{s_op}": round(wod_op["L1"]["recall"], 4),
        })
        if buckets:
            rb = range_breakdown(frames, iou_thresh=iou_op, mode="3d")
            for label, r in rb.items():
                rec[f"{p}l1_ap_{s_op}_r{label}"] = round(r["ap"], 4)
    return rec


def main(argv=None):
    """Returns the records printed (one dict a JSON line)."""
    args = parse_args(argv)
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.data.synthetic_device import make_batch_device
    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.train.state import create_train_state
    from rangedet_tpu_torch.train.train_step import make_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA card")
    cfg = load_config(args.config, is_train=True)
    cfg_t = load_config(args.config, is_train=False)
    if args.batch:
        cfg = cfg.replace(batch_image=args.batch)
    cfg_t = cfg_t.replace(min_score={k: args.min_score
                                     for k in cfg_t.min_score})
    # warm-up in epochs of 1000 steps, cosine over the --steps horizon
    cfg = cfg.replace(
        optimizer=args.optimizer, base_lr=args.lr, lr_mode="cosine",
        warmup_epochs=args.warmup_steps / 1000.0, auto_scale_lr=False,
        begin_epoch=0, end_epoch=max(1, args.steps // 1000))

    families = scene_families(cfg_t.class_names, args.far)
    H, W = cfg.feat_size
    scene = dict(H=H, W=W, pad_w=cfg.pad_field[1], max_gt=cfg.max_gt_boxes,
                 num_boxes=args.boxes, families=families,
                 num_clutter=args.clutter)

    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(device), cfg, 1000, seed=None)
    if args.resume:
        saved = torch.load(args.resume, map_location="cpu",
                           weights_only=True)
        model.load_state_dict(saved["model"], strict=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
    step = make_train_step(state, cfg)
    eval_step = make_eval_step(model, cfg_t)

    # fixed held-out scenes from reserved seeds, batched for the eval step
    EB = args.eval_batch
    holdout = []
    for i in range(0, args.holdout_frames, EB):
        hb = make_batch_device(
            torch.Generator(device=device).manual_seed(HOLDOUT_SEED0 + i),
            B=EB, **scene)
        holdout.append((build_eval_inputs(hb, cfg_t, device),
                        {k: v.cpu().numpy() for k, v in hb.items()}))

    def run_eval(buckets=False):
        model.eval()
        try:
            outs = [{c: {k: v.cpu().numpy() for k, v in o.items()}
                     for c, o in eval_step(eb).items()}
                    for eb, _ in holdout]
        finally:
            model.train()
        return score(outs, [hb for _, hb in holdout], cfg_t, families,
                     buckets)

    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    t0 = time.time()
    n_run = (args.steps if args.stop_after is None
             else min(args.steps, args.stop_after))
    for step_i in range(1, n_run + 1):
        # the scenes of step n: a generator seeded by (--seed, n)
        gen = torch.Generator(device=device).manual_seed(
            (args.seed << 32) | (step_i + args.step0))
        batch = make_batch_device(gen, B=cfg.batch_image, **scene)
        m = step(batch)
        # the segment's last step always logs and evals, whether or not
        # --log-every divides it
        last = step_i == n_run
        if step_i % args.log_every == 0 or last:
            rec = {"step": step_i + args.step0,
                   "loss": round(float(m["total_loss"]), 4),
                   "s_per_step": round((time.time() - t0) / step_i, 3)}
            rec.update({k: round(float(v), 4) for k, v in m.items()
                        if k != "total_loss"})
            if step_i % args.eval_every == 0 or last:
                rec.update(run_eval(
                    buckets=step_i + args.step0 >= args.steps))
            emit(rec)
    if n_run == 0:
        # eval-only (--stop-after 0 --resume): the held-out metrics of the
        # resumed model at step0, the RANGE buckets at the horizon
        rec = {"step": args.step0}
        rec.update(run_eval(buckets=args.step0 >= args.steps))
        emit(rec)

    if args.save:
        torch.save({"model": model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step}, args.save)
        emit({"saved": args.save})
    emit({"done": True, "total_s": round(time.time() - t0, 1)})
    return records


if __name__ == "__main__":
    main()
