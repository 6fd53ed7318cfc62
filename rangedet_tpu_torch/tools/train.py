"""Train entry point of the PyTorch port, counterpart of ``tools/train.py``,
one process per card:

    python -m rangedet_tpu_torch.tools.train --config rangedet_veh_wo_aug_4_18e \
        [--data-root DIR] [--sampling-rate N] [--batch B] [--epochs E] \
        [--steps-per-epoch N] [--resume] [--checkpoint-every N] \
        [--num-workers N] [--eval-every N] [--eval-frames N] [--seed S] \
        [--experiment-dir DIR] [--tensorboard] [--profile-steps N] \
        [--device-cache [--device-augment flip,rotation]] [--device cuda]
    python -m rangedet_tpu_torch.tools.train --config ... --synthetic \
        --steps-per-epoch 50 --epochs 2
    torchrun --nproc_per_node N -m rangedet_tpu_torch.tools.train \
        --config ... [--mesh data=D[,model=M]] [--gspmd-width] [--multihost]

Data parallel (``parallel/``): under a launcher that starts N > 1
processes (``torchrun`` / ``python -m torch.distributed.run``; several
nodes with ``--nnodes`` and a rendezvous, or with ``--multihost``, which
joins from the launcher's environment even at one process), each process
joins the group (nccl on the card ``cuda:LOCAL_RANK``, gloo on the CPU;
``--device cuda:N`` puts every rank on card N, over gloo where the node
has fewer cards than ranks),
trains ``--batch`` frames a step on its own card and the ranks reduce
their gradients before each update (``parallel/dp_step.py``): the global
batch is ``batch * N``, and ``auto_scale_lr`` scales to it. The recipe's
``sync_bn`` (the default) makes every BatchNorm sum its statistics over
the ranks; ``sync_bn=False`` keeps each rank's ("localbn"). Synthetic data:
every rank draws the global batch of the step and trains on its rows.
Files: rank r loads its own ``1/N`` of the split (``BatchLoader``'s
``host_id`` / ``num_hosts``), ``--batch`` frames a step, so an epoch
covers the split once. Rank 0's parameters are broadcast after the init
and after ``--resume`` (every rank restores); only rank 0 writes
checkpoints (the others wait for it), ``log.txt``, TensorBoard and the
profiler's trace; every rank runs the validation.

Width sharding (``tools/train.py:165-193``): ``--mesh data=D,model=M`` over
D*M processes, data-major (rank r = d*M + m). The M ranks of data index d
train on the same ``--batch`` frames, each on its columns ``[m*W/M,
(m+1)*W/M)`` of the range image; every 3x3 conv, deconv and the
Meta-Kernel exchange halo columns with the neighbours (``parallel/
halo.py``), the targets sum their per-box point counts over the width
group, and sync BatchNorm over all D*M ranks is forced (``sync_bn=False``
is overridden, with a line in the log). The global batch is ``batch * D``.
The shard width must be a multiple of the largest FPN stride and of the
backbone's width stride 16, and hold the deconv's halo
(``dist.check_width_split``); a mesh that is not is refused. Synthetic
data: every rank draws the global batch and takes its rows and columns.
Files: the loader of data index d's first rank (m = 0) loads its ``1/D``
of the split and augments, and broadcasts each batch over the width group
(``dist.share_batch``), so the group's ranks see the same frames.
``--gspmd-width`` (JAX's GSPMD width path, which JAX's tests hold equal to
the explicit-halo step) runs the same explicit-halo step here, the port
having no auto-partitioner, and says so in the log. Validation runs the
full frames on every rank, the width ops off. ``--mesh`` must cover the
number of processes; ``--device-cache`` over several processes is refused.

The weights are a seeded random init (``--seed``). Frames come from the
roidb files of the recipe's ``image_set`` under ``--data-root`` (subsampled
by ``--sampling-rate``, ``data/waymo.py``) through ``data/loader.py``'s
``BatchLoader`` (``--num-workers`` threads, a shuffle an epoch); an epoch
is ``len(loader)`` steps. With ``--synthetic`` or no data root, step i of
epoch e trains on ``tools/train.py``'s synthetic draw, a fresh batch of
raytraced vehicle frames ``make_batch(cfg, batch, seed=e*10000 + i,
style="vehicles")`` (``synthetic_batch``), and an epoch is 100 steps.
``--steps-per-epoch`` sets the epoch's length and cuts it. A background
thread prepares the next batches while the card runs the step and puts
them on the card ``PREFETCH_DEPTH`` batches ahead (tools/train.py:353-367,
``data/prefetch.py:threaded_device_prefetch``): through pinned memory, on
a side CUDA stream that the step's stream waits on, so a batch's copy
overlaps the kernels of the steps dispatched meanwhile. Under width
sharding the put shares the batch over the width group, a collective, so
it runs in the main thread (``device_prefetch``, as JAX's loop puts).
``data_ms`` is the main thread's wait for the next batch (with, under
width sharding, the put of a later one), ``step_ms`` the step alone.

The run trains epochs ``begin_epoch .. end_epoch`` (``--epochs`` sets
``end_epoch``) with the recipe's optimizer (sgd, adamw, adamws), clip
(elementwise, global_norm) and ``remat``. The LR (and with onecycle the
momentum) follows the recipe's schedule over those epochs, its base
rescaled as ``tools/train.py`` does when ``auto_scale_lr`` is set (base_lr
* batch / 16). The log (``utils/logger.py``: the console and
``<experiment>/<name>/log.txt``) gets a speedometer line every
``log_frequency`` steps: frames/s, LR, the mean ms of the wait for a batch
and of a step, the mean losses. The steps chain without a wait for the
card; their metrics stay there until the window of ``log_frequency`` steps
(or the epoch's end) is fetched in one round trip. ``--tensorboard``
writes the line's scalars and each validation's AP under
``<experiment>/<name>/tb``; ``--profile-steps N`` a ``torch.profiler``
trace of steps 10 .. 10+N under ``<experiment>/<name>/traces``. At the end
of every
``checkpoint_every_epochs``-th epoch a checkpoint (``train/checkpoint.py``)
is written under the experiment directory (``--checkpoint-every 0``: none);
``--resume`` restores the latest one and goes on at the next epoch, its LR
from the restored step count. Every ``--eval-every`` epochs the model is
scored on ``--eval-frames`` frames of the validation split (synthetic
frames without a data root) by ``build_validation``.

With ``--device-cache`` (``tools/train.py``'s device-cache path) every
frame of the split is mapped once through ``record_to_inputs`` and packed
(``data/device_cache.py``, ~1.9 MB a full-size frame against ~11.6 MB),
and the packed frames are staged on the card; the log gets the staged MB
and the map and transfer seconds. Epoch e's order is numpy
``RandomState(seed * 100003 + e).permutation``, moved to the card once an
epoch; a step slices its indices there, gathers its frames, unpacks them,
runs ``--device-augment``'s augmentations (``augment_raw``; draws from a
generator seeded by (seed + 7, the step count), so a resumed run draws
what an unbroken one draws) and finalizes the batch, all on the card. An
epoch is ``n_frames // batch`` steps. The validation frames are cached on
the card too. The recipe's host ``augment`` cannot be combined with it.
Synthetic data (``--synthetic`` or no data root) takes the cache's place,
as in ``tools/train.py``: ``--device-cache`` is then ignored with a
warning, and ``--device-augment`` is refused.

Two properties of ``tools/train.py``'s loader are kept, so that the port
trains on the frames the JAX loop trains on: the loader's shuffle is
seeded 0 whatever ``--seed`` is, afresh in every process, so a resumed run
draws the orders an uninterrupted run drew from its start; and its first
shuffle is spent before the first epoch (JAX draws a sample batch from it
to initialise), so epoch e trains on the loader's permutation e + 1.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.profiler import record_function

STEPS_PER_EPOCH = 100  # tools/train.py's default for synthetic data
LOADER_SEED = 0  # tools/train.py passes no seed to its BatchLoader
DEVICE_AUGMENTATIONS = ("flip", "rotation")
PROFILE_START = 10  # tools/train.py's ProfilerHook starts at step 10
PREFETCH_DEPTH = 2  # batches put on the device ahead (tools/train.py:364)


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
                   help="override cfg.experiment_dir (checkpoints and "
                        "logs root)")
    p.add_argument("--tensorboard", action="store_true",
                   help="write TensorBoard scalars (losses, lr, frames/s, "
                        "data/step ms, validation AP) under "
                        "<experiment>/<name>/tb")
    p.add_argument("--profile-steps", type=int, default=0,
                   help=f"write a torch.profiler trace of N steps from "
                        f"step {PROFILE_START} under <experiment>/<name>/"
                        f"traces")
    p.add_argument("--device-cache", action="store_true",
                   help="stage the packed dataset on the card once and "
                        "build every batch there from its indices "
                        "(data/device_cache.py)")
    p.add_argument("--device-augment", default="",
                   help="comma list of on-card augmentations of the "
                        "--device-cache path (flip, rotation), fresh draws "
                        "each step")
    jax_flags = p.add_argument_group(
        "JAX command-line parity",
        "accepted as tools/train.py takes them; the launcher's WORLD_SIZE "
        "sets the number of ranks")
    jax_flags.add_argument(
        "--mesh", default=None,
        help="'data=D[,model=M]' with D*M the number of processes (default: "
             "the recipe's mesh_shape, else all on data); a 'model' axis "
             "shards the range image's width over M ranks")
    jax_flags.add_argument(
        "--gspmd-width", action="store_true",
        help="JAX's GSPMD width path; the port has no auto-partitioner and "
             "runs the explicit-halo width step, which JAX's tests hold "
             "equal to it")
    jax_flags.add_argument(
        "--multihost", action="store_true",
        help="join the process group from the launcher's environment; the "
             "port joins whenever WORLD_SIZE > 1 (one process drives one "
             "card), so at one process this changes nothing but the join: "
             "a group of one runs the plain step")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card cuda:LOCAL_RANK), cuda:N (every "
                        "rank on card N) or cpu")
    return p.parse_args(argv)


def apply_overrides(cfg, args, world: int = 1):
    """The recipe with the command line's overrides, as ``tools/train.py``
    applies them, and its LR scaled to the global batch, ``batch_image``
    frames on each of ``world`` data ranks."""
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
    if cfg.auto_scale_lr:  # tools/train.py:155-159, the global batch
        cfg = cfg.replace(
            base_lr=cfg.base_lr * cfg.batch_image * world / 16.0)
    return cfg


def synthetic_batch(cfg, epoch: int, i: int, d: int = 0, n_data: int = 1,
                    m: int = 0, n_width: int = 1):
    """The host batch of step i of ``epoch`` on mesh place (d, m): its rows
    (and columns) of ``tools/train.py``'s synthetic draw, a fresh global
    batch of ``batch_image * n_data`` raytraced vehicle scenes per step."""
    from rangedet_tpu_torch.data.synthetic import make_batch
    from rangedet_tpu_torch.parallel.dist import local_rows

    return local_rows(make_batch(cfg, cfg.batch_image * n_data,
                                 seed=epoch * 10000 + i, style="vehicles"),
                      d, n_data, m, n_width)


def epoch_source(cfg, args, logger, ranks):
    """-> (steps per epoch, epoch_batches(epoch) -> iterator of host
    batches, shared), the batches of mesh place ``ranks`` from the files
    of ``cfg.data_root`` or synthetic scenes. ``shared``: the batches are
    data index d's whole frames, loaded on its first width rank alone
    (the others' iterators give empty dicts in their place), for the loop
    to share (``dist.share_batch``) and split by columns."""
    d, n_data = ranks.data_index, ranks.n_data
    m, n_width = ranks.width_index, ranks.n_width
    if args.synthetic or not cfg.data_root:
        spe = args.steps_per_epoch or STEPS_PER_EPOCH
        logger.info("training on synthetic data")

        def epoch_batches(epoch):
            return (synthetic_batch(cfg, epoch, i, d, n_data, m, n_width)
                    for i in range(spe))

        return spe, epoch_batches, False

    from rangedet_tpu_torch.data.loader import BatchLoader
    from rangedet_tpu_torch.data.waymo import load_roidbs, record_to_inputs

    roidb = load_roidbs(cfg.data_root, cfg.image_set, cfg.sampling_rate,
                        cfg.filter_class)
    logger.info(f"loaded {len(roidb)} roidb records")
    loader = BatchLoader(
        roidb,
        lambda rec: record_to_inputs(rec, cfg.pad_field, cfg.max_gt_boxes,
                                     augment=cfg.augment),
        batch_size=cfg.batch_image, num_workers=args.num_workers,
        seed=LOADER_SEED, host_id=d, num_hosts=n_data)
    spe = args.steps_per_epoch or len(loader)
    if m:  # the width group's first rank loads; this one receives
        return spe, lambda epoch: iter([{}] * len(loader)), True
    loader.skip_epoch()  # the shuffle tools/train.py's sample batch spends
    return spe, lambda epoch: loader.epoch(), n_width > 1


def augment_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s on-card augmentation draws, seeded
    by (seed + 7, step) as ``tools/train.py`` folds the step count into
    ``PRNGKey(seed + 7)``: the draws depend on the step alone."""
    return torch.Generator(device=device).manual_seed(
        ((seed + 7) << 32) | step)


def stage_frames(roidb, cfg, device):
    """Map every record once through ``record_to_inputs`` (no host
    augmentation), pack and stack the frames and stage them on ``device``.
    -> (cache, the frames' image width, staged MB, map s, transfer s)."""
    from rangedet_tpu_torch.data.device_cache import (
        pack_inputs,
        stack_packed,
        to_device,
    )
    from rangedet_tpu_torch.data.waymo import record_to_inputs

    with np.load(roidb[0]["pc_url"]) as d:
        data_w = int(d["range_image"].shape[1])
    t0 = time.perf_counter()
    host = stack_packed([
        pack_inputs(record_to_inputs(rec, cfg.pad_field, cfg.max_gt_boxes))
        for rec in roidb])
    t1 = time.perf_counter()
    cache = to_device(host, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mb = sum(v.nbytes for v in host.values()) / 1e6
    return cache, data_w, mb, t1 - t0, time.perf_counter() - t1


def device_cache_source(cfg, args, logger, device):
    """The ``--device-cache`` path: -> (steps per epoch, epoch_batches(epoch)
    -> generator of index tensors on the card, to_batch(idx, step) -> the
    step's batch built on the card)."""
    from rangedet_tpu_torch.data.device_cache import (
        augment_raw,
        finalize_inputs,
        gather_packed,
        unpack_raw,
    )
    from rangedet_tpu_torch.data.waymo import load_roidbs

    if cfg.augment:
        raise SystemExit(
            "--device-cache caches pre-augmentation frames; use "
            "--device-augment instead of the recipe's augment")
    names = tuple(n for n in args.device_augment.split(",") if n)
    roidb = load_roidbs(cfg.data_root, cfg.image_set, cfg.sampling_rate,
                        cfg.filter_class)
    logger.info(f"loaded {len(roidb)} roidb records (device-cache mode)")
    cache, data_w, mb, map_s, put_s = stage_frames(roidb, cfg, device)
    logger.info(f"device cache staged: {len(roidb)} frames, {mb:.1f} MB "
                f"(map {map_s:.2f}s, transfer {put_s:.3f}s = "
                f"{mb / max(put_s, 1e-9):.1f} MB/s)")
    n, B = len(roidb), cfg.batch_image
    spe = args.steps_per_epoch or n // B

    def epoch_batches(epoch):
        order = torch.from_numpy(np.random.RandomState(
            args.seed * 100003 + epoch).permutation(n)).to(device)
        for s in range(spe):
            lo = (s * B) % max(n - B + 1, 1)
            yield order[lo:lo + B]

    def to_batch(idx, step):
        with record_function("device_cache_batch"):
            raw = unpack_raw(gather_packed(cache, idx), data_w)
            if names:
                raw = augment_raw(raw, data_w, names=names,
                                  generator=augment_generator(
                                      args.seed, step, device))
            return finalize_inputs(raw)

    return spe, epoch_batches, to_batch


def fetch_window(metrics, keys):
    """The metrics of a window of steps (device scalars, one dict a step)
    on the host in one round trip: one stacked tensor, one copy. -> one
    row of floats a step, in ``keys`` order."""
    flat = torch.stack([m[k].float() for m in metrics for k in keys]
                       ).tolist()
    n = len(keys)
    return [flat[r * n:(r + 1) * n] for r in range(len(metrics))]


def hyperparams(opt):
    """(lr, momentum) of the optimizer's last update: SGD's momentum or
    Adam's beta1."""
    group = opt.param_groups[0]
    return group["lr"], (group["betas"][0] if "betas" in group
                         else group["momentum"])


def check_jax_flags(args, cfg, world: int):
    """The mesh (``--mesh``, else the recipe's ``mesh_shape``) over
    ``world`` processes, as ``tools/train.py:165-193`` takes it: -> (D, M).
    A width mesh's shards must stay phase-aligned. Exits on a mesh that
    does not fit."""
    from rangedet_tpu_torch.models.dla_backbone import (
        DECONV_HALO,
        WIDTH_STRIDE,
    )
    from rangedet_tpu_torch.parallel import dist as pdist

    try:
        n_data, n_width = pdist.check_mesh(
            pdist.parse_mesh(args.mesh) if args.mesh else cfg.mesh_shape,
            world)
        if n_width > 1:
            pdist.check_width_split(cfg.pad_field[1], n_width,
                                    cfg.fpn_strides, WIDTH_STRIDE,
                                    DECONV_HALO)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return n_data, n_width


def main(argv=None):
    """Returns (one record per step: its epoch, step count, lr, momentum
    (SGD's, or Adam's beta1), data_ms, step_ms and metrics as floats; the
    TrainState; {epoch: validation result} of the epochs validated).
    ``step_ms`` is the host's time to dispatch the step, from the batch in
    hand to the step's return (on the card the device runs behind it), and
    on a metrics window's last step also the window's sync and fetch."""
    args = parse_args(argv)
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.parallel import dist as pdist

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA card")
    bad = set(n for n in args.device_augment.split(",") if n) - set(
        DEVICE_AUGMENTATIONS)
    if bad or (args.device_augment and not args.device_cache):
        raise SystemExit(f"--device-augment takes {DEVICE_AUGMENTATIONS} "
                         f"with --device-cache; got {args.device_augment!r}")
    cfg = load_config(args.config, is_train=True)
    world = int(os.environ.get("WORLD_SIZE", 1))
    mesh = check_jax_flags(args, cfg, world)
    if args.device_cache and world > 1:
        raise SystemExit("--device-cache is single-process only "
                         "(tools/train.py:222)")
    ranks = pdist.join(args.device, always=args.multihost)
    try:
        if ranks.group is not None:
            ranks = pdist.with_mesh(ranks, *mesh)
        return _train(args, cfg, ranks)
    finally:
        pdist.leave(ranks)


def _train(args, cfg, ranks):
    """main's run, in the process group ``ranks`` joined and placed on the
    mesh."""
    from rangedet_tpu_torch.data.prefetch import (
        device_prefetch,
        threaded_device_prefetch,
        threaded_prefetch,
    )
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.models.layers import (
        set_sync_group,
        set_width_group,
    )
    from rangedet_tpu_torch.parallel import dist as pdist
    from rangedet_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from rangedet_tpu_torch.train.state import create_train_state, param_count
    from rangedet_tpu_torch.train.train_step import (
        batch_to_device,
        build_train_step_fn,
    )
    from rangedet_tpu_torch.utils.logger import (
        DetailSpeedometer,
        ProfilerHook,
        ScalarWriter,
        config_logger,
    )

    device, rank, world = ranks.device, ranks.rank, ranks.world
    n_data, n_width = ranks.n_data, ranks.n_width
    lead = rank == 0  # writes checkpoints, log.txt, TensorBoard, the trace
    cfg = apply_overrides(cfg, args, n_data)
    run_dir = os.path.join(cfg.experiment_dir, cfg.name)
    logger = config_logger(cfg.experiment_dir, cfg.name, log_file=lead)
    if n_width > 1:
        if not cfg.sync_bn:
            logger.info("width sharding forces sync-BN semantics")
        cfg = cfg.replace(width_axis="model", sync_bn=True)
        H, W = cfg.pad_field
        logger.info(f"width sharding: mesh data={n_data},model={n_width}; "
                    f"rank {rank} is (d, m) = ({ranks.data_index}, "
                    f"{ranks.width_index}), columns "
                    f"[{ranks.width_index * W // n_width}, "
                    f"{(ranks.width_index + 1) * W // n_width}) of {H}x{W}")
        if args.gspmd_width:
            logger.info("--gspmd-width: no auto-partitioner in the port; "
                        "running the explicit-halo width step, which JAX's "
                        "tests hold equal to the GSPMD step")
    backend = (torch.distributed.get_backend(ranks.group)
               if ranks.group is not None else "no group")
    logger.info(f"data parallel: {world} rank(s), {backend}; rank {rank} "
                f"on {device}, {cfg.batch_image} frames a step, global "
                f"batch {cfg.batch_image * n_data}, BatchNorm "
                f"{'sync' if cfg.sync_bn else 'local'}")
    # tools/train.py: synthetic data (or no data root) wins over the cache
    cached = args.device_cache and not args.synthetic and bool(cfg.data_root)
    if args.device_cache and not cached:
        if args.device_augment:
            raise SystemExit("--device-augment needs the device cache, and "
                             "synthetic data (--synthetic or no data root) "
                             "takes its place")
        logger.warning("--device-cache ignored: synthetic data (--synthetic "
                       "or no data root) takes its place")
    if cached:
        spe, epoch_batches, to_batch = device_cache_source(cfg, args, logger,
                                                           device)
    else:
        spe, epoch_batches, shared = epoch_source(cfg, args, logger, ranks)

        def put(batch):  # run PREFETCH_DEPTH batches ahead
            if shared:  # the width group's frames, this rank's columns
                batch = pdist.local_rows(pdist.share_batch(batch, ranks), 0,
                                         1, ranks.width_index, n_width)
            return batch_to_device(batch, device)

    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(args.seed))
    state = create_train_state(model.to(device), cfg, spe, seed=None)
    logger.info(f"params: {param_count(state) / 1e6:.2f}M")
    begin_epoch = cfg.begin_epoch
    if args.resume:  # every rank reads the checkpoint
        state, ep = restore_checkpoint(state, cfg)
        if ep is not None:
            begin_epoch = ep + 1
            logger.info(f"resumed from epoch {ep}")
    if world > 1:
        pdist.replicate_state(state.model, ranks.group)
        set_sync_group(state.model, ranks.group if cfg.sync_bn else None)
        set_width_group(state.model, ranks.width_group)
    step = build_train_step_fn(state, cfg, ranks.group, ranks.width_group)
    logger.info(
        f"{args.config}: batch {cfg.batch_image}, lr {cfg.base_lr:.5f} "
        f"({cfg.lr_mode}), {cfg.optimizer}, clip {cfg.clip_mode}, remat "
        f"{cfg.remat}, {spe} steps an epoch, epochs {begin_epoch}.."
        f"{cfg.end_epoch - 1}, weights seeded init ({args.seed}), device "
        f"{device}")

    tb = (ScalarWriter(os.path.join(run_dir, "tb"), logger)
          if args.tensorboard and lead else None)
    speedometer = DetailSpeedometer(cfg.batch_image * n_data,
                                    cfg.log_frequency, logger, tb=tb)
    profiler = ProfilerHook(os.path.join(run_dir, "traces"), PROFILE_START,
                            args.profile_steps if lead else 0)
    history, validations = [], {}
    val_fn = None
    try:
        for epoch in range(begin_epoch, cfg.end_epoch):
            t_ep = time.perf_counter()
            # Steps chain with no per-step fetch or sync: each step's
            # metrics stay on the device until the window of
            # log_frequency steps is fetched in one round trip
            # (tools/train.py:356-405)
            pending = []  # per step: (batch index, record, metrics)

            def flush():
                if not pending:
                    return
                t_f = time.perf_counter()
                keys = sorted(pending[0][2])
                rows = fetch_window([m for _, _, m in pending], keys)
                sync_s = time.perf_counter() - t_f
                speedometer.tick(0.0, sync_s)  # the sync is step time
                pending[-1][1]["step_ms"] += sync_s * 1e3
                for (bi, rec, _), row in zip(pending, rows):
                    rec.update(zip(keys, row))
                    lr = rec["lr"] if speedometer.due_next else None
                    speedometer(epoch, bi, {k: rec[k] for k in keys},
                                lr=lr, global_step=rec["step"])
                    history.append(rec)
                pending.clear()

            # the cache path's batches are index slices already on the
            # card; the loader's are put there PREFETCH_DEPTH ahead, from
            # the prefetch thread, or in this thread where the put shares
            # the batch over the width group (a collective, in order)
            if cached:
                batches = epoch_batches(epoch)
            elif shared:
                batches = device_prefetch(
                    threaded_prefetch(iter(epoch_batches(epoch)), depth=2),
                    put, depth=PREFETCH_DEPTH, device=device)
            else:
                batches = threaded_device_prefetch(
                    iter(epoch_batches(epoch)), put, depth=PREFETCH_DEPTH,
                    device=device)
            try:
                i = 0
                while True:
                    t0 = time.perf_counter()
                    batch = next(batches, None)
                    if batch is None:
                        break
                    t1 = time.perf_counter()
                    profiler(state.step)
                    metrics = step(to_batch(batch, state.step) if cached
                                   else batch)
                    t2 = time.perf_counter()
                    speedometer.tick(t1 - t0, t2 - t1)
                    lr, mom = hyperparams(state.optimizer)
                    pending.append((i, dict(
                        epoch=epoch, step=state.step - 1, lr=lr,
                        momentum=mom, data_ms=(t1 - t0) * 1e3,
                        step_ms=(t2 - t1) * 1e3), metrics))
                    if len(pending) >= cfg.log_frequency:
                        flush()
                    i += 1
                    if args.steps_per_epoch and i >= args.steps_per_epoch:
                        break
            finally:
                batches.close()  # ends the prefetch thread, loader workers
            flush()
            logger.info(f"epoch {epoch} done in "
                        f"{time.perf_counter() - t_ep:.1f}s")
            every = cfg.checkpoint_every_epochs
            if every and (epoch + 1) % every == 0:
                if lead:
                    logger.info(
                        f"checkpoint: {save_checkpoint(state, cfg, epoch)}")
                pdist.barrier(ranks)  # a --resume on any rank finds it
            if args.eval_every and (epoch + 1) % args.eval_every == 0:
                if val_fn is None:
                    val_fn = build_validation(state.model, cfg,
                                              args.synthetic, cfg.data_root,
                                              n_frames=args.eval_frames,
                                              device_cache=cached)
                validations[epoch] = val_fn()
                logger.info(f"epoch {epoch} validation: {validations[epoch]}")
                if tb is not None:
                    tb.scalars({f"val/{name}_ap": m["ap"] for name, m in
                                validations[epoch].items()}, state.step)
            if tb is not None:
                tb.flush()
    finally:
        profiler.close()
        if tb is not None:
            tb.close()
    logger.info("training complete")
    return history, state, validations


def build_validation(model, cfg, synthetic: bool, data_root: str = "",
                     n_frames: int = 8, device_cache: bool = False):
    """A reusable in-process validation runner, counterpart of
    ``tools/train.py:build_validation``: synthetic vehicle scenes when
    ``synthetic`` or there is no data root, else the first ``n_frames``
    frames of ``data_root``'s validation split. run() evaluates the model
    in eval mode (and restores its mode) at the WOD operating points
    (cfg.eval_iou_thresh, cfg.eval_iou_mode) and returns {class: {ap,
    recall, precision}}. With ``device_cache`` the validation frames are
    packed and staged on the model's card once (``stage_frames``) and each
    eval rebuilds them there, as the train step does."""
    from rangedet_tpu_torch.eval.evaluator import evaluate
    from rangedet_tpu_torch.infer import make_eval_step
    from rangedet_tpu_torch.models.layers import without_width

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

        if device_cache:
            from rangedet_tpu_torch.data.device_cache import (
                expand_inputs,
                gather_packed,
            )

            device = next(model.parameters()).device
            vcache, data_w, _, _, _ = stage_frames(roidb, cfg, device)
            ids = torch.arange(len(roidb), device=device)

            def frames():
                for i, rec in enumerate(roidb):
                    yield expand_inputs(gather_packed(vcache, ids[i:i + 1]),
                                        data_w), gt_of(rec)
        else:

            def frames():
                for rec in roidb:
                    b = record_to_inputs(rec, cfg.pad_field,
                                         cfg.max_gt_boxes)
                    yield {k: v[None] for k, v in b.items()}, gt_of(rec)

    def run():
        was_training = model.training
        model.eval()
        try:
            with without_width(model):
                return evaluate(model, cfg_t, frames(),
                                iou_thresh=cfg.eval_iou_thresh,
                                mode=cfg.eval_iou_mode, eval_step=eval_step)
        finally:
            model.train(was_training)

    return run


if __name__ == "__main__":
    main()
