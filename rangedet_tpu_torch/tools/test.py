"""Inference entry point of the PyTorch port, counterpart of
``tools/test.py``: forward, top-k, decode and weighted NMS per batch of
frames, written as the two-dump prediction pickle (annotation dict, then
output dict) that ``tools/create_prediction_bin_3d.py`` reads.

    python -m rangedet_tpu_torch.tools.test --config rangedet_veh_wo_aug_4_18e \
        --synthetic 2 [--batch 1] [--device cuda] [--weights w.npz] [--output p.pkl]

Without ``--weights`` (a flat .npz of the JAX parameter tree, see
``rangedet_tpu_torch/convert.py``) the model is initialised from a fixed
seed.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

INIT_SEED = 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run RangeDet inference (PyTorch)")
    p.add_argument("--config", required=True,
                   help="recipe name or path to a recipe .py")
    p.add_argument("--synthetic", type=int, default=4,
                   help="number of synthetic frames to run")
    p.add_argument("--batch", type=int, default=1, help="frames per step")
    p.add_argument("--output", default=None, help="output pickle path")
    p.add_argument("--device", default="cuda")
    p.add_argument("--weights", default=None,
                   help=".npz of the JAX parameter tree (convert.save_npz)")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    from rangedet_tpu_torch.data.synthetic import make_batch
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.convert import load_npz
    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from rangedet_tpu_torch.models import RangeDet

    device = torch.device(args.device)
    cfg = load_config(args.config, is_train=False)
    model = RangeDet(**cfg.model_kwargs())
    if args.weights:
        model.load_state_dict(load_npz(args.weights), strict=True)
        print(f"weights: {args.weights}")
    else:
        model.init_from(torch.Generator().manual_seed(INIT_SEED))
        print(f"weights: seeded init ({INIT_SEED})")
    model = model.to(device).eval()
    eval_step = make_eval_step(model, cfg)

    frames = [(f"synthetic_{i}", i) for i in range(args.synthetic)]
    output_dict, annotation_dict = {}, {}
    n_truncated = 0
    t0 = time.perf_counter()
    for start in range(0, len(frames), args.batch):
        group = frames[start:start + args.batch]
        real = len(group)
        group = group + [group[-1]] * (args.batch - real)  # pad the tail
        raw = [make_batch(cfg, 1, seed=seed) for _, seed in group]
        stacked = {k: np.concatenate([b[k] for b in raw]) for k in raw[0]}
        out = eval_step(build_eval_inputs(stacked, cfg, device))
        out = {c: {k: v.cpu().numpy() for k, v in r.items()}
               for c, r in out.items()}
        for j in range(real):
            rec_id = group[j][0]
            det, truncated = {}, False
            for cls_name, res in out.items():
                det[cls_name] = res["boxes"][j][res["valid"][j]][
                    : cfg.max_det_per_image]
                truncated |= bool(res["truncated"][j])
            n_truncated += truncated
            output_dict[rec_id] = {
                "det_xyzlwhyaws": det,
                "meta_info": {"name": rec_id, "timestamp_micros": 0},
                "truncated": truncated,
            }
            annotation_dict[rec_id] = {}
    dt = time.perf_counter() - t0
    n = len(frames)
    print(f"{n} frames in {dt:.1f}s on {device} (batch {args.batch}); "
          f"{n_truncated} flagged truncated (device_topk cap bound)")

    out_path = args.output or os.path.join(
        cfg.experiment_dir, cfg.name, "predictions_torch.pkl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:  # two dumps, as the reference writes
        pickle.dump(annotation_dict, f)
        pickle.dump(output_dict, f)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
