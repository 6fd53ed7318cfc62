"""Train entry point of the PyTorch port, counterpart of ``tools/train.py``
on synthetic scenes:

    python -m rangedet_tpu_torch.tools.train --config rangedet_veh_wo_aug_4_18e \
        --synthetic --steps 3 [--steps-per-epoch N] [--experiment-dir DIR] \
        [--device cuda]

The weights are a seeded random init. The data are synthetic scenes drawn
as ``tools/train.py --synthetic`` draws them: step i of epoch e trains on
a fresh batch of ``batch_image`` raytraced vehicle frames,
``make_batch(cfg, batch_image, seed=e*10000 + i, style="vehicles")``
(``synthetic_batch``), prepared in a background thread while the card runs
the step before. An epoch is ``--steps-per-epoch`` steps (default 100, as
in ``tools/train.py``). The LR follows the recipe's schedule over
``end_epoch`` such epochs, rescaled as ``tools/train.py`` does when
``auto_scale_lr`` is set (base_lr * global batch / 16). Each step prints
its losses. A checkpoint (``train/checkpoint.py``) is written under the
experiment directory at the end of every ``checkpoint_every_epochs``-th
epoch and at the end of the run, as epoch (steps - 1) // steps per epoch.
Resume and evaluation during training are not ported yet;
``build_validation`` is the in-process validation they will call.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

SEED = 0
STEPS_PER_EPOCH = 100  # tools/train.py's default for synthetic data


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train RangeDet (PyTorch)")
    p.add_argument("--config", required=True,
                   help="recipe name or path to a recipe .py")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic scenes (the only data source "
                        "ported so far, so also the default)")
    p.add_argument("--steps-per-epoch", type=int, default=STEPS_PER_EPOCH)
    p.add_argument("--steps", type=int, default=10, help="steps to run")
    p.add_argument("--experiment-dir", default=None,
                   help="override cfg.experiment_dir (checkpoint root)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def synthetic_batch(cfg, epoch: int, i: int):
    """The host batch of step i of ``epoch``: ``tools/train.py``'s
    synthetic draw, a fresh batch of raytraced vehicle scenes per step."""
    from rangedet_tpu_torch.data.synthetic import make_batch

    return make_batch(cfg, cfg.batch_image, seed=epoch * 10000 + i,
                      style="vehicles")


def main(argv=None):
    """Returns (per-step metrics as floats, the TrainState)."""
    args = parse_args(argv)
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.data.prefetch import threaded_prefetch
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.train.checkpoint import save_checkpoint
    from rangedet_tpu_torch.train.state import create_train_state
    from rangedet_tpu_torch.train.train_step import (
        batch_to_device,
        make_train_step,
    )

    device = torch.device(args.device)
    cfg = load_config(args.config, is_train=True)
    if args.experiment_dir:
        cfg = cfg.replace(experiment_dir=args.experiment_dir)
    if cfg.auto_scale_lr:  # one device: global batch = batch_image
        cfg = cfg.replace(base_lr=cfg.base_lr * cfg.batch_image / 16.0)
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    spe = args.steps_per_epoch
    state = create_train_state(model.to(device), cfg, spe, seed=None)
    step = make_train_step(state, cfg)
    print(f"{args.config}: batch {cfg.batch_image}, lr {cfg.base_lr:.5f}, "
          f"weights seeded init ({SEED}), "
          f"device {device}")

    batches = threaded_prefetch(
        (synthetic_batch(cfg, *divmod(i, spe)) for i in range(args.steps)),
        depth=2)
    history = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in
                   step(batch_to_device(batch, device)).items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = (time.perf_counter() - t0) * 1e3
        history.append(metrics)
        losses = " ".join(f"{k} {v:.5f}" for k, v in sorted(metrics.items()))
        print(f"step {i}: {losses} ({dt:.1f} ms)")
        epoch, last = divmod(i + 1, spe)
        if (not last and epoch % cfg.checkpoint_every_epochs == 0
                and i + 1 < args.steps):
            print(f"saved {save_checkpoint(state, cfg, epoch - 1)}")
    if args.steps:
        epoch = (args.steps - 1) // spe
        print(f"saved {save_checkpoint(state, cfg, epoch)}")
    return history, state


def build_validation(model, cfg, synthetic: bool, data_root: str = "",
                     n_frames: int = 8):
    """A reusable in-process validation runner, counterpart of
    ``tools/train.py:build_validation``: synthetic vehicle scenes when
    ``synthetic`` or there is no data root, else the first ``n_frames``
    frames of ``data_root``'s validation split. run() evaluates the model
    in eval mode (and restores its mode) at the WOD operating points
    (cfg.eval_iou_thresh, cfg.eval_iou_mode) and returns {class: {ap,
    recall, precision}}. The JAX package's device cache is not ported."""
    from rangedet_tpu_torch.eval.evaluator import evaluate
    from rangedet_tpu_torch.infer import make_eval_step

    cfg_t = cfg.replace(is_train=False, data_root=data_root or cfg.data_root)
    eval_step = make_eval_step(model, cfg_t)
    enum_of = {"veh": 1.0, "ped": 2.0, "cyc": 4.0}

    if synthetic or not cfg_t.data_root:
        from rangedet_tpu_torch.data.synthetic import make_batch

        def frames():
            for i in range(n_frames):
                b = make_batch(cfg_t, 1, seed=90000 + i, num_boxes=8,
                               style="vehicles")
                valid = b["gt_valid"][0] > 0
                gt = {
                    name: b["gt_csa"][0][
                        valid & (b["gt_class"][0] == enum_of.get(name, 1.0))
                    ]
                    for name in cfg.class_names
                }
                yield b, gt
    else:
        from rangedet_tpu_torch.data.waymo import load_roidbs, record_to_inputs

        roidb = load_roidbs(cfg_t.data_root, "validation", 1,
                            cfg.filter_class)[:n_frames]

        def gt_of(rec):
            cls = np.asarray(rec.get("gt_class", np.zeros(0))).reshape(-1)
            csa = np.asarray(
                rec.get("gt_bbox_csa", np.zeros((0, 7)))).reshape(-1, 7)
            return {name: csa[cls == enum_of.get(name, 1.0)]
                    for name in cfg.class_names}

        def frames():
            for rec in roidb:
                b = record_to_inputs(rec, cfg.pad_field, cfg.max_gt_boxes)
                yield {k: v[None] for k, v in b.items()}, gt_of(rec)

    def run():
        was_training = model.training
        model.eval()
        try:
            return evaluate(model, cfg_t, frames(),
                            iou_thresh=cfg.eval_iou_thresh,
                            mode=cfg.eval_iou_mode, eval_step=eval_step)
        finally:
            model.train(was_training)

    return run


if __name__ == "__main__":
    main()
