"""Inference entry point of the PyTorch port, counterpart of
``tools/test.py``: forward, top-k, decode and weighted NMS per batch of
frames, written as the two-dump prediction pickle (annotation dict, then
output dict) that ``tools/create_prediction_bin_3d.py`` and
``tools/evaluate_pred.py`` read.

    python -m rangedet_tpu_torch.tools.test --config rangedet_veh_wo_aug_4_18e \
        --data-root DIR [--image-set validation] [--batch 4] \
        [--experiment-dir DIR] [--epoch N | --weights w.npz] [--device cuda] \
        [--output p.pkl] [--profile-steps N]
    python -m rangedet_tpu_torch.tools.test --config ... --synthetic 2

Frames come from the roidb files under ``DATA_ROOT/<image set>/*.roidb``
and the per-frame ``.npz`` files they name (``data/waymo.py``), or, with
``--synthetic N`` or no data root, from N seeded synthetic frames. They
run in batches of ``--batch``, the last one padded with copies of its last
frame. Weights come from ``--weights`` (a flat .npz of the JAX parameter
tree, see ``rangedet_tpu_torch/convert.py``), else from the port's
checkpoint of ``--epoch`` (default: the latest) under the experiment
directory, else from a fixed seed; the run prints which.

Over several processes (``torchrun --nproc_per_node N -m
rangedet_tpu_torch.tools.test ...``, or ``--multihost`` to join at one
process), the counterpart of ``tools/test.py``'s eval batch sharded over
the devices: each rank runs on its card (``cuda:LOCAL_RANK``) the frames
i = rank (mod N), ``--batch`` of them a step, and rank 0 gathers the
outputs and writes the pickle in the order of a one-process run, which
it equals.

``--profile-steps N`` writes a ``torch.profiler`` trace of eval steps
1 .. N (step 0 loads the kernels) under ``<experiment>/<name>/
eval_traces``, which Chrome and TensorBoard read (``utils/logger.py:
ProfilerHook``; rank 0 only). The eval step's ranges (``utils/spans.py``)
are in it: ``forward``, ``postprocess``, and inside the latter ``topk``,
``decode`` and ``wnms``, whose ``wnms.round`` and ``host_sync`` ranges
count the weighted NMS's rounds and its waits for the card.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

INIT_SEED = 0
PROFILE_START = 1  # step 0 loads the kernels and grows the allocator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run RangeDet inference (PyTorch)")
    p.add_argument("--config", required=True,
                   help="recipe name or path to a recipe .py")
    p.add_argument("--data-root", default=None,
                   help="override cfg.data_root (roidb + npz files)")
    p.add_argument("--image-set", default=None,
                   help="override cfg.image_set (e.g. validation)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic frames instead of a dataset "
                        "(4 when there is no data root)")
    p.add_argument("--batch", type=int, default=1, help="frames per step")
    p.add_argument("--experiment-dir", default=None,
                   help="override cfg.experiment_dir (checkpoint root)")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch (default: the latest)")
    p.add_argument("--weights", default=None,
                   help=".npz of the JAX parameter tree (convert.save_npz)")
    p.add_argument("--output", default=None, help="output pickle path")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group from the launcher's "
                        "environment even at one process (it is joined "
                        "whenever WORLD_SIZE > 1)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card cuda:LOCAL_RANK) or cpu")
    p.add_argument("--profile-steps", type=int, default=0,
                   help=f"write a torch.profiler trace of N eval steps from "
                        f"step {PROFILE_START} under <experiment>/<name>/"
                        f"eval_traces")
    return p.parse_args(argv)


def load_weights(model, cfg, weights=None, epoch=None) -> str:
    """Set the model's weights from ``weights`` (npz), else the port's
    checkpoint of ``epoch`` or the latest, else the seeded init. Returns
    what it used."""
    from rangedet_tpu_torch.convert import load_npz
    from rangedet_tpu_torch.train.checkpoint import (
        checkpoint_path,
        restore_checkpoint,
    )

    if weights:
        model.load_state_dict(load_npz(weights), strict=True)
        return f"weights: {weights}"
    _, ep = restore_checkpoint(model, cfg, epoch)
    if ep is not None:
        return f"weights: checkpoint epoch {ep} ({checkpoint_path(cfg, ep)})"
    model.init_from(torch.Generator().manual_seed(INIT_SEED))
    return f"weights: seeded init ({INIT_SEED}), no checkpoint in " \
           f"{os.path.join(cfg.experiment_dir, cfg.name)}"


def frame_source(cfg, synthetic: int, rank: int = 0, world: int = 1):
    """(number of frames, iterator of (rec_id, batch of one frame,
    annotation dict)) from synthetic frames or from cfg.data_root; the
    iterator yields rank ``rank``'s frames of ``world``: i = rank (mod
    world)."""
    if synthetic or not cfg.data_root:
        from rangedet_tpu_torch.data.synthetic import make_batch

        n = synthetic or 4
        return n, ((f"synthetic_{i}", make_batch(cfg, 1, seed=i), {})
                   for i in range(rank, n, world))
    from rangedet_tpu_torch.data.waymo import load_roidbs, record_to_inputs

    roidb = load_roidbs(cfg.data_root, cfg.image_set, 1, None)

    def frames():
        for rec in roidb[rank::world]:
            b = record_to_inputs(rec, cfg.pad_field, cfg.max_gt_boxes)
            anno = {
                "gt_bbox_csa": np.asarray(
                    rec.get("gt_bbox_csa", np.zeros((0, 7)))),
                "gt_class": np.asarray(rec.get("gt_class", np.zeros(0))),
                "points_in_box": np.asarray(
                    rec.get("points_in_box", np.zeros(0))),
            }
            if isinstance(rec.get("meta_info"), dict):
                anno["meta_info"] = rec["meta_info"]
            yield (rec.get("rec_id", rec.get("pc_url", "?")),
                   {k: v[None] for k, v in b.items()}, anno)

    return len(roidb), frames()


def batched(frames, batch: int):
    """Groups of ``batch`` frames, the host preparing the next ones in a
    background thread; the tail group padded with copies of its last frame.
    Yields (group, number of real frames)."""
    from rangedet_tpu_torch.data.prefetch import threaded_prefetch

    buf = []
    for item in threaded_prefetch(frames, depth=2 * batch):
        buf.append(item)
        if len(buf) == batch:
            yield buf, batch
            buf = []
    if buf:
        real = len(buf)
        yield buf + [buf[-1]] * (batch - real), real


def main(argv=None) -> str:
    """Returns the pickle's path (on rank 0; None on the other ranks)."""
    args = parse_args(argv)
    from rangedet_tpu_torch.parallel import dist as pdist

    ranks = pdist.join(args.device, always=args.multihost)
    try:
        return _test(args, ranks)
    finally:
        pdist.leave(ranks)


def _test(args, ranks):
    """main's run, in the process group ``ranks`` joined."""
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.utils.logger import ProfilerHook

    device, rank, world = ranks.device, ranks.rank, ranks.world
    if world > 1:
        print(f"rank {rank} of {world} "
              f"({torch.distributed.get_backend(ranks.group)}) on {device}")
    cfg = load_config(args.config, is_train=False)
    if args.data_root:
        cfg = cfg.replace(data_root=args.data_root)
    if args.experiment_dir:
        cfg = cfg.replace(experiment_dir=args.experiment_dir)
    if args.image_set:
        cfg = cfg.replace(image_set=(args.image_set,))
    model = RangeDet(**cfg.model_kwargs())
    print(load_weights(model, cfg, args.weights, args.epoch))
    model = model.to(device).eval()
    eval_step = make_eval_step(model, cfg)
    n_frames, frames = frame_source(cfg, args.synthetic, rank, world)
    print(f"{n_frames} eval frames" + (f", {len(range(rank, n_frames, world))}"
                                       f" on rank {rank}" if world > 1
                                       else ""))

    profiler = ProfilerHook(
        os.path.join(cfg.experiment_dir, cfg.name, "eval_traces"),
        PROFILE_START, args.profile_steps if rank == 0 else 0)
    rows = []  # (rec_id, annotation, output) a frame, in order
    n = n_truncated = 0
    t0 = time.perf_counter()
    try:
        for step, (group, real) in enumerate(batched(frames, args.batch)):
            stacked = {k: np.concatenate([b[k] for _, b, _ in group])
                       for k in group[0][1]}
            profiler(step)
            out = eval_step(build_eval_inputs(stacked, cfg, device))
            # the reference pickle contract (create_prediction_bin_3d.py:
            # 85-97): per frame {'det_xyzlwhyaws': {class: (N, 8) [x,y,z,
            # l,w,h,yaw,score]}, 'meta_info': {'name', 'timestamp_micros'}}
            out = {c: {k: v.cpu().numpy() for k, v in r.items()}
                   for c, r in out.items()}
            for j in range(real):
                rec_id, _, anno = group[j]
                det, truncated = {}, False
                for cls_name, res in out.items():
                    det[cls_name] = res["boxes"][j][res["valid"][j]][
                        : cfg.max_det_per_image]
                    truncated |= bool(res["truncated"][j])
                n_truncated += truncated
                rows.append((rec_id, anno, {
                    "det_xyzlwhyaws": det,
                    "meta_info": anno.get("meta_info", {
                        "name": str(rec_id), "timestamp_micros": 0}),
                    "truncated": truncated,
                }))
                n += 1
    finally:
        profiler.close()
    dt = time.perf_counter() - t0
    print(f"{n} frames in {dt:.1f}s on {device} (batch {args.batch}); "
          f"{n_truncated} flagged truncated (device_topk cap bound)")
    if world > 1:
        # rank r ran frames r, r + N, ...: interleave them back
        parts = [None] * world if rank == 0 else None
        torch.distributed.gather_object(rows, parts, dst=0,
                                        group=ranks.group)
        if rank:
            return None
        rows = [parts[i % world][i // world] for i in range(n_frames)]
    annotation_dict = {rec_id: anno for rec_id, anno, _ in rows}
    output_dict = {rec_id: out for rec_id, _, out in rows}

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
