"""Train entry point of the PyTorch port, counterpart of ``tools/train.py``
on synthetic scenes:

    python -m rangedet_tpu_torch.tools.train --config rangedet_veh_wo_aug_4_18e \
        --synthetic 4 --steps 3 [--device cuda]

The weights are a seeded random init. ``--synthetic N`` makes N frames
(seeds 0..N-1, ``data/synthetic.py``), grouped into batches of the
recipe's ``batch_image``; step i trains on batch i mod (N / batch_image).
The LR follows the recipe's schedule over ``end_epoch`` epochs of
``STEPS_PER_EPOCH`` steps, rescaled as ``tools/train.py`` does when
``auto_scale_lr`` is set (base_lr * global batch / 16). Each step prints
its losses. Checkpoints, resume and in-training evaluation are not ported
yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

SEED = 0
STEPS_PER_EPOCH = 100


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train RangeDet (PyTorch)")
    p.add_argument("--config", required=True,
                   help="recipe name or path to a recipe .py")
    p.add_argument("--synthetic", type=int, default=4,
                   help="number of synthetic frames to cycle through")
    p.add_argument("--steps", type=int, default=10, help="steps to run")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the list of per-step metrics (floats)."""
    args = parse_args(argv)
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.data.synthetic import make_batch
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.train.state import create_train_state
    from rangedet_tpu_torch.train.train_step import (
        batch_to_device,
        make_train_step,
    )

    device = torch.device(args.device)
    cfg = load_config(args.config, is_train=True)
    if cfg.auto_scale_lr:  # one device: global batch = batch_image
        cfg = cfg.replace(base_lr=cfg.base_lr * cfg.batch_image / 16.0)
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    state = create_train_state(model.to(device), cfg, STEPS_PER_EPOCH,
                               seed=None)
    step = make_train_step(state, cfg)
    print(f"{args.config}: batch {cfg.batch_image}, lr {cfg.base_lr:.5f}, "
          f"weights seeded init ({SEED}), "
          f"device {device}")

    frames = [make_batch(cfg, 1, seed=i) for i in range(args.synthetic)]
    n_batches = max(1, len(frames) // cfg.batch_image)
    batches = []
    for j in range(n_batches):
        group = [frames[(j * cfg.batch_image + k) % len(frames)]
                 for k in range(cfg.batch_image)]
        batches.append(batch_to_device(
            {k: np.concatenate([f[k] for f in group]) for k in group[0]},
            device))

    history = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in
                   step(batches[i % n_batches]).items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = (time.perf_counter() - t0) * 1e3
        history.append(metrics)
        losses = " ".join(f"{k} {v:.5f}" for k, v in sorted(metrics.items()))
        print(f"step {i}: {losses} ({dt:.1f} ms)")
    return history


if __name__ == "__main__":
    main()
