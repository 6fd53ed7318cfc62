"""Where the train step's time goes on the card: the full-size train step
of a recipe at B=2, seeded random weights, one synthetic batch, under
``torch.profiler``.

    python -m rangedet_tpu_torch.tools.profile_train [--batch 2]
        [--recipe rangedet_veh_wo_aug_4_18e] [--out profile_train.txt]

Prints the wall time of the profiled steps, the device time of each stage
of the step (targets, forward, losses with the IoU target, backward,
optimizer, and the busy time no stage holds), the forward's
Meta-Kernel block (the "meta_block" range, inside the forward), the IoU
target inside the losses (the "iou_target" range, and its prep and clip
kernels by name), the device busy share, the peak device memory of the
steps, and the kernels by total device time; writes the full table to
``--out``. It profiles the recipe as it ships (the fused block in training),
then the same step with the materialized block, for its stage line. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .profile_eval import _self_device_us, range_device_ms

RECIPE = "rangedet_veh_wo_aug_4_18e"
ITERS = 5  # profiled steps, after 2 warm-up steps
SEED = 0
STAGES = ("targets", "forward", "losses", "backward", "optimizer")
NESTED = ("meta_block", "iou_target")  # ranges inside a stage
# the IoU target's kernels by name: its candidate prep, its clip and clean
IOU_KERNELS = {"iou_prep": ("iou_prep_kernel",),
               "iou_clip": ("iou_clip_kernel", "iou_clean_kernel")}


def profile_step(cfg, batch_size):
    """Profile ITERS steps after 2 warm-up steps. Returns the wall ms per
    step, the busy device ms per step, the device ms of each range and of
    the IoU target's kernels, the peak device memory of the steps (GiB)
    and the kernel events."""
    from rangedet_tpu_torch.data.synthetic import make_batch
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.train.state import create_train_state
    from rangedet_tpu_torch.train.train_step import (
        batch_to_device,
        make_train_step,
    )

    dev = torch.device("cuda")
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    state = create_train_state(model.to(dev), cfg, 100, seed=None)
    step = make_train_step(state, cfg)
    batch = batch_to_device(
        make_batch(cfg, batch_size, seed=SEED, num_boxes=20), dev)

    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    names = STAGES + NESTED
    ranges = range_device_ms(prof, names, ITERS)
    events = prof.key_averages()
    kernels = [e for e in events if e.key not in names
               and str(e.device_type).endswith("CUDA")
               and _self_device_us(e) > 0]
    busy_ms = sum(_self_device_us(e) for e in kernels) / 1e3 / ITERS
    for part, frags in IOU_KERNELS.items():
        ranges[part] = sum(_self_device_us(e) for e in kernels
                           if any(f in e.key for f in frags)) / 1e3 / ITERS
    ranges["unattributed"] = busy_ms - sum(ranges[k] for k in STAGES)
    return wall_ms, busy_ms, ranges, peak_gib, kernels


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--recipe", default=RECIPE)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")

    from rangedet_tpu_torch.configs import load_config

    cfg = load_config(args.recipe, is_train=True).replace(
        base_lr=0.01, warmup_epochs=0)
    forms = [("fused", cfg)] if cfg.use_pallas_meta else []
    forms.append(("materialized", cfg.replace(use_pallas_meta=False)))
    for i, (form, c) in enumerate(forms):
        wall_ms, busy_ms, ranges, peak_gib, kernels = profile_step(
            c, args.batch)
        print(f"profile_train: {args.recipe} B={args.batch}, {form} "
              f"Meta-Kernel "
              f"block, on {torch.cuda.get_device_name(0)}: wall "
              f"{wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
              f"({100 * busy_ms / wall_ms:.1f}%); device ms by stage: "
              + ", ".join(f"{k} {ranges[k]:.2f}" for k in STAGES)
              + f", no stage {ranges['unattributed']:.2f}; meta_block "
              f"{ranges['meta_block']:.2f} (of the forward); iou_target "
              f"{ranges['iou_target']:.3f} (of the losses; kernels: prep "
              f"{ranges['iou_prep']:.3f}, clip {ranges['iou_clip']:.3f}); "
              f"peak memory {peak_gib:.2f} GiB")
        if i:  # the kernel table of the recipe's own step only
            continue
        kernels.sort(key=_self_device_us, reverse=True)
        lines = [f"{'device ms/step':>15} {'share':>6} {'calls/step':>10}  "
                 f"kernel"]
        for e in kernels:
            ms = _self_device_us(e) / 1e3 / ITERS
            lines.append(f"{ms:15.3f} {100 * ms / busy_ms:5.1f}% "
                         f"{e.count / ITERS:10.1f}  {e.key[:110]}")
        print("\n".join(lines[:30]))
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
