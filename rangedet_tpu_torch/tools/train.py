"""Train entry point of the PyTorch port, counterpart of ``tools/train.py``
on one card:

    python -m rangedet_tpu_torch.tools.train --config rangedet_veh_wo_aug_4_18e \
        [--data-root DIR] [--sampling-rate N] [--batch B] [--epochs E] \
        [--steps-per-epoch N] [--resume] [--checkpoint-every N] \
        [--num-workers N] [--eval-every N] [--eval-frames N] [--seed S] \
        [--experiment-dir DIR] [--device cuda]
    python -m rangedet_tpu_torch.tools.train --config ... --synthetic \
        --steps-per-epoch 50 --epochs 2

The weights are a seeded random init (``--seed``). Frames come from the
roidb files of the recipe's ``image_set`` under ``--data-root`` (subsampled
by ``--sampling-rate``, ``data/waymo.py``) through ``data/loader.py``'s
``BatchLoader`` (``--num-workers`` threads, a shuffle an epoch); an epoch
is ``len(loader)`` steps. With ``--synthetic`` or no data root, step i of
epoch e trains on ``tools/train.py``'s synthetic draw, a fresh batch of
raytraced vehicle frames ``make_batch(cfg, batch, seed=e*10000 + i,
style="vehicles")`` (``synthetic_batch``), and an epoch is 100 steps.
``--steps-per-epoch`` sets the epoch's length and cuts it. A background
thread prepares the next batches while the card runs the step.

The run trains epochs ``begin_epoch .. end_epoch`` (``--epochs`` sets
``end_epoch``). The LR follows the recipe's schedule over those epochs,
rescaled as ``tools/train.py`` does when ``auto_scale_lr`` is set (base_lr
* batch / 16). Each step prints its losses, its LR, the ms it waited for
its batch and the ms of the step. At the end of every
``checkpoint_every_epochs``-th epoch a checkpoint (``train/checkpoint.py``)
is written under the experiment directory (``--checkpoint-every 0``: none);
``--resume`` restores the latest one and goes on at the next epoch, its LR
from the restored step count. Every ``--eval-every`` epochs the model is
scored on ``--eval-frames`` frames of the validation split (synthetic
frames without a data root) by ``build_validation``.

Two properties of ``tools/train.py``'s loader are kept, so that the port
trains on the frames the JAX loop trains on: the loader's shuffle is
seeded 0 whatever ``--seed`` is, afresh in every process, so a resumed run
draws the orders an uninterrupted run drew from its start; and its first
shuffle is spent before the first epoch (JAX draws a sample batch from it
to initialise), so epoch e trains on the loader's permutation e + 1.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

STEPS_PER_EPOCH = 100  # tools/train.py's default for synthetic data
LOADER_SEED = 0  # tools/train.py passes no seed to its BatchLoader


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train RangeDet (PyTorch)")
    p.add_argument("--config", required=True,
                   help="recipe name or path to a recipe .py")
    p.add_argument("--data-root", default=None, help="override cfg.data_root")
    p.add_argument("--sampling-rate", type=int, default=None,
                   help="override cfg.sampling_rate (1 = every frame)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic scenes")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="override cfg.batch_image")
    p.add_argument("--epochs", type=int, default=None,
                   help="override cfg.end_epoch")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="override cfg.checkpoint_every_epochs (0 disables)")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--eval-every", type=int, default=0,
                   help="run validation AP every N epochs")
    p.add_argument("--eval-frames", type=int, default=8,
                   help="validation frames per in-run eval")
    p.add_argument("--seed", type=int, default=0, help="seed of the init")
    p.add_argument("--experiment-dir", default=None,
                   help="override cfg.experiment_dir (checkpoint root)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def apply_overrides(cfg, args):
    """The recipe with the command line's overrides, as ``tools/train.py``
    applies them, and its LR scaled to the batch."""
    if args.data_root:
        cfg = cfg.replace(data_root=args.data_root)
    if args.sampling_rate is not None:
        if args.sampling_rate < 1:
            raise SystemExit("--sampling-rate must be >= 1")
        cfg = cfg.replace(sampling_rate=args.sampling_rate)
    if args.batch:
        cfg = cfg.replace(batch_image=args.batch)
    if args.epochs:
        cfg = cfg.replace(end_epoch=args.epochs)
    if args.checkpoint_every is not None:
        if args.checkpoint_every < 0:
            raise SystemExit("--checkpoint-every must be >= 0 (0 disables)")
        cfg = cfg.replace(checkpoint_every_epochs=args.checkpoint_every)
    if args.experiment_dir:
        cfg = cfg.replace(experiment_dir=args.experiment_dir)
    if cfg.auto_scale_lr:  # one card: the global batch is batch_image
        cfg = cfg.replace(base_lr=cfg.base_lr * cfg.batch_image / 16.0)
    return cfg


def synthetic_batch(cfg, epoch: int, i: int):
    """The host batch of step i of ``epoch``: ``tools/train.py``'s
    synthetic draw, a fresh batch of raytraced vehicle scenes per step."""
    from rangedet_tpu_torch.data.synthetic import make_batch

    return make_batch(cfg, cfg.batch_image, seed=epoch * 10000 + i,
                      style="vehicles")


def epoch_source(cfg, args):
    """-> (steps per epoch, epoch_batches(epoch) -> iterator of host
    batches), from the files of ``cfg.data_root`` or synthetic scenes."""
    if args.synthetic or not cfg.data_root:
        spe = args.steps_per_epoch or STEPS_PER_EPOCH
        print("training on synthetic data")

        def epoch_batches(epoch):
            return (synthetic_batch(cfg, epoch, i) for i in range(spe))

        return spe, epoch_batches

    from rangedet_tpu_torch.data.loader import BatchLoader
    from rangedet_tpu_torch.data.waymo import load_roidbs, record_to_inputs

    roidb = load_roidbs(cfg.data_root, cfg.image_set, cfg.sampling_rate,
                        cfg.filter_class)
    print(f"loaded {len(roidb)} roidb records")
    loader = BatchLoader(
        roidb,
        lambda rec: record_to_inputs(rec, cfg.pad_field, cfg.max_gt_boxes,
                                     augment=cfg.augment),
        batch_size=cfg.batch_image, num_workers=args.num_workers,
        seed=LOADER_SEED)
    loader.skip_epoch()  # the shuffle tools/train.py's sample batch spends
    return args.steps_per_epoch or len(loader), lambda epoch: loader.epoch()


def main(argv=None):
    """Returns (one record per step: its epoch, step count, lr, data_ms,
    step_ms and metrics as floats; the TrainState; {epoch: validation
    result} of the epochs validated)."""
    args = parse_args(argv)
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.data.prefetch import threaded_prefetch
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from rangedet_tpu_torch.train.state import create_train_state
    from rangedet_tpu_torch.train.train_step import (
        batch_to_device,
        make_train_step,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA card")
    cfg = apply_overrides(load_config(args.config, is_train=True), args)
    spe, epoch_batches = epoch_source(cfg, args)

    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(args.seed))
    state = create_train_state(model.to(device), cfg, spe, seed=None)
    begin_epoch = cfg.begin_epoch
    if args.resume:
        state, ep = restore_checkpoint(state, cfg)
        if ep is not None:
            begin_epoch = ep + 1
            print(f"resumed from epoch {ep}")
    step = make_train_step(state, cfg)
    print(f"{args.config}: batch {cfg.batch_image}, lr {cfg.base_lr:.5f}, "
          f"{spe} steps an epoch, epochs {begin_epoch}..{cfg.end_epoch - 1}, "
          f"weights seeded init ({args.seed}), device {device}")

    history, validations = [], {}
    val_fn = None
    for epoch in range(begin_epoch, cfg.end_epoch):
        t_ep = time.perf_counter()
        batches = threaded_prefetch(iter(epoch_batches(epoch)), depth=2)
        try:
            i = 0
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                t1 = time.perf_counter()
                lr = state.schedule(state.step)
                metrics = {k: float(v) for k, v in
                           step(batch_to_device(batch, device)).items()}
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                rec = dict(epoch=epoch, step=state.step - 1, lr=lr,
                           data_ms=(t1 - t0) * 1e3,
                           step_ms=(time.perf_counter() - t1) * 1e3,
                           **metrics)
                history.append(rec)
                losses = " ".join(f"{k} {v:.5f}"
                                  for k, v in sorted(metrics.items()))
                print(f"epoch {epoch} step {i}: {losses} lr {lr:.6g} "
                      f"data_ms {rec['data_ms']:.1f} "
                      f"step_ms {rec['step_ms']:.1f}")
                i += 1
                if args.steps_per_epoch and i >= args.steps_per_epoch:
                    break
        finally:
            batches.close()  # ends the prefetch thread and loader workers
        print(f"epoch {epoch} done in {time.perf_counter() - t_ep:.1f}s")
        every = cfg.checkpoint_every_epochs
        if every and (epoch + 1) % every == 0:
            print(f"checkpoint: {save_checkpoint(state, cfg, epoch)}")
        if args.eval_every and (epoch + 1) % args.eval_every == 0:
            if val_fn is None:
                val_fn = build_validation(state.model, cfg, args.synthetic,
                                          cfg.data_root,
                                          n_frames=args.eval_frames)
            validations[epoch] = val_fn()
            print(f"epoch {epoch} validation: {validations[epoch]}")
    print("training complete")
    return history, state, validations


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
