#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, one line of output each (or a table), failing on the first error:

1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   the build of the hand-written kernels from ``rangedet_tpu_torch/csrc``;
2. the conv3x3 forward kernel against its plain PyTorch version on the
   card, at every (Ci, Co, W, stride, ingest) the B=1 forward launches and
   at the largest shape for B=4: max error, bit-equal repeats, ms of both
   and of cuDNN, the device time of its prologue, GEMM and reduction, and
   its sum over the forward against cuDNN's, which must stay within
   FWD_CUDNN_MAX;
3. the full serving path of ``rangedet_veh_wo_aug_4_18e`` at 64x2656 with
   seeded random weights, at B=4 and B=1: the launch counts per forward
   of the conv kernel and of the Meta-Kernel taps kernel (one), finite
   outputs, logits and deltas against the plain path, the median eval-step
   time, its weighted-NMS share and the peak memory;
4. ``python -m rangedet_tpu_torch.tools.test`` on 2 synthetic frames;
5. the train kernels against their plain versions at every distinct shape
   of one B=2 train step of the recipe (its fused Meta-Kernel block
   included): conv3x3 forward (stats, ingest + stats), dgrad (plain, cot,
   affine-backward + cot), wgrad (plain, ingest + cot), the stride-2 and
   deconv backward through the autograd Function, the IoU target at each
   level (on the inputs the step gave it: the output within IOU_TOL of the
   plain version and a bit-equal repeat; the blocks whose nv or live
   candidate rows differ from the plain prep's counted; the prep, the
   clip and the old prep with this clip timed; the clip summed over the
   step within IOU_CLIP_BOUND_MAX of its bound over the pairs the
   candidate contract runs, and its bound over the live pairs printed
   beside), and every launch of the Meta-Kernel block's kernels (meta_stats,
   meta_agg, the block backward in both modes) on the inputs the step gave
   it, each twice with bit-equal outputs; a zeroed dA planted in the
   backward's output must fail its gates; on meta_stats' inputs, kernel 7
   against the training plain version's tap product a (at most TAP_OFF_MAX
   of the elements differ, each by one bf16 ulp) and meta_stats' sums
   against float64 sums of kernel 7's output (TAP_SUM_TOL): the two
   kernels form one a; meta_stats, meta_agg and the backward summed over
   the step must stay within META_STATS_BOUND_MAX, META_AGG_BOUND_MAX and
   META_BWD_BOUND_MAX of their f32-FFMA bounds (their tensor-core bounds,
   the kernels line's bound_ms, printed beside);
   max error, kernel ms, plain ms, cuDNN ms and the bound; for the
   three conv kernels also the device time of their prologue and GEMM
   (and reduction), the GEMM's TFLOP/s and registers and spills, and
   their sums over the step against cuDNN's, which must stay within
   FWD_CUDNN_MAX, DGRAD_CUDNN_MAX and WGRAD_CUDNN_MAX;
6. the full-size train step at B=2: launches per step against the counts
   the config implies, gradients of the kernel path against the plain path
   and of both bf16 paths against an f32 step, the same gates shown to
   reject two planted faults (a zeroed dgrad, a sign-flipped wgrad), step
   1's losses with the fused block against the materialized block, 5 steps
   with finite and falling loss (no launch of the taps' kernel), two steps
   from one state with bit-equal losses, the median step time and peak
   memory;
7. the Meta-Kernel's taps (kernel 7) and the serving path from files: the
   kernel against its plain version on the inputs a B=4 and a B=1 eval
   forward give it (max error, bit-equal repeat, kernel ms, plain ms,
   bound; within META_TAPS_BOUND_MAX of its f32-FFMA bound, its
   tensor-core bound, the kernels line's bound_ms, printed beside), its
   gradient
   against the plain version's, the eval step with and without it (outputs
   within the model gate, step ms, peak memory); then training and
   serving from files: 8 full-size frames written as a training split and
   2 as a validation split (roidb + npz), ``tools.train --data-root`` for
   one epoch of 2 steps at B=2 (2 loader workers) into checkpoint 0, then
   ``--epochs 2 --resume --eval-every 1``: the resume marker, step count 4,
   checkpoints 0 and 1, the momentum buffers on the card, a finite
   validation, the launches of each run's 2 steps equal to twice phase
   6's per step (meta_stats 2 a Meta-Kernel block, no taps) and the
   validation's a B=1 eval forward a frame (the taps only there), the
   loader's wait and the step ms of each step, and no thread left behind;
   ``tools.test`` from the validation files at epoch 1 (every frame in
   the pickle, the launches of its steps), ``tools.evaluate_pred`` on the
   pickle, the restored model's eval outputs bit-equal to the trained
   model's, and ``tools.eval_checkpoint`` (finite lines);
8. the three-class recipe ``rangedet_multiclass_all_36e`` at full width and
   depth (64x2656, seeded random weights, raytraced frames of classes 1, 2
   and 4): one B=2 train step with the launches the config implies (9
   IoU-target calls, 3 levels x 3 classes, one prep and one clip each),
   each IoU call on the inputs the step gave it (class k's view of the
   head's (B, H, Ws, 24) deltas) within IOU_TOL of the plain version on
   the same view, a bit-equal repeat and the same bits as on a contiguous
   copy, timed; 5 steps with finite, falling loss, the median step time
   and peak memory; the eval step at B=4 and B=1 (launches, each class's
   boxes finite and its valid count printed, logits and deltas against the
   plain path, the median, the WNMS share over the three classes, peak
   memory); then from 8 training and 2 validation frames of three classes,
   ``tools.train`` for one epoch of 2 steps with the recipe's augmentation
   (every training frame the loader maps goes through
   ``data/augment.py:apply_augmentations`` with both names, counted by a
   wrapper around it), checkpoint 0, a finite validation of three classes,
   no thread left behind; ``tools.test`` at epoch 0 (every frame, three
   class keys), ``tools.evaluate_pred`` (one line per class at the recipe's
   IoU) and ``tools.create_prediction_bin_3d`` (rows of Waymo types 2 and 4);
9. the wide-channel recipe ``rangedet_veh_tpuopt_all_36e`` at full width and
   depth (64x2656, backbone widths up to 256, its Meta-Kernel block at
   C=128, Cm=32, Co=128): one B=2 train step with the launches the config
   implies, the Meta-Kernel kernels' C=128 instance on every launch of the
   step under phase 5's correctness gates (bit-equal repeats, kernel 7 and
   meta_stats forming one tap product, the zeroed dA rejected; their speed
   against their bounds printed, not gated), every conv shape of the step
   that phase 5 did not run held once as forward, dgrad and wgrad under
   phase 5's gates, 5 steps with finite, falling loss, the median step time
   and peak memory; the eval step at B=4 and B=1 (launches, finite boxes,
   the kernel path within MODEL_TOL of the plain path, the median, the WNMS
   share, peak memory) with kernel 7 at 9C = 1152 channels on its inputs
   within one bf16 ulp of the f32 plain version and within JAX's bound of
   the bf16 one;
10. ``remat`` and the train CLI's options on ``rangedet_veh_wo_aug_4_18e``
   at 64x2656, B=2: (a) a step with ``remat`` (every backbone stage
   recomputed in the backward, the fused block with it) and (b) one with
   ``remat_meta`` on the materialized block, each against the plain step
   from the same init and batch: losses, parameters and running statistics
   bit-equal; launches (remat: + the stages' 49 convs and one meta_stats
   and meta_agg; remat_meta: unchanged); median step ms and peak memory of
   both; (c) ``tools.train`` from 16 full-size files with a recipe of
   adamws, onecycle, the global-norm clip, remat and log_frequency 4,
   ``--tensorboard --profile-steps 2``, 2 epochs: finite losses, launches
   16 x (a)'s, a speedometer line every 4 steps in log.txt with the
   schedule's lr, LR and momentum of every step as the schedules give
   them, after every step the kernels AdamWS standardizes at mean 0 and
   std 1 a filter within STD_TOL and no other weight, TensorBoard events
   (or its one warning where tensorboard is not installed), the trace of
   steps 10-11 naming the conv kernels; then ``--resume``: the AdamW state
   restored bit-equal to the first run's end, moments on the card, step
   counts on the host; (d) the resumed epoch's data_ms and step_ms of
   steps 2..8 and the device's busy share over the traced window;
11. device-side data and the training probes on ``rangedet_veh_wo_aug_4_18e``
   at 64x2650 (pad 2656): (a) ``data/synthetic_device.py``'s raytracer on
   the card, B=2 with 10 boxes, vehicles and three families with 4 clutter
   cuboids: against the same draws rendered on the CPU (within RENDER_TOL,
   face pixels that flip at most FACE_FLIP_FRAC), the census (the
   assigner's counts equal gt_num_points), ms a batch beside the host
   ``make_batch``'s; (b) 16 files packed and staged
   (``data/device_cache.py``): MB a frame against the f32 dict's,
   ``expand_inputs`` and ``augment_raw`` under explicit draws against
   ``record_to_inputs`` without and with the host augmentation under the
   matched draws, within the codec's budgets (CHANNEL_TOL), and
   ``build_train_targets`` on the device-augmented batch against the host's
   outside the codec's band (``cached_targets_check``: the pixels within
   PC_BAND of a box face or RANGE_BAND of an FPN interval bound counted);
   (c) ``tools.train --device-cache --device-augment flip,rotation`` for an
   epoch of 3 steps under torch.profiler (launches 3 x phase 6's per step,
   host-to-device bytes inside the steps under H2D_STEP_MAX a step), then
   ``--resume --eval-every 1`` (the cached validation's launches, the flips
   and shifts an unbroken run draws, finite losses), then an epoch like
   [10]'s of the recipe from the 16 files with the cache (its steady step
   ms beside [10]'s loader epoch); (d) ``tools.quality_probe`` for 20 steps
   with 8 held-out frames (every line parses, the AP keys finite, launches
   20 steps + 2 eval forwards), ``--save`` then ``--stop-after 0 --resume
   --save`` (the AP keys of the last record; the state it saves bit-equal
   to the file it resumed: the model's parameters and buffers, the
   optimizer's state, the step count), ``tools.overfit_probe`` for 3 steps,
   and their s_per_step;
12. data-parallel training of ``rangedet_veh_wo_aug_4_18e`` at 64x2656
   (``rangedet_tpu_torch/parallel/``): (a) one B=1 train step, every launch
   of it through phase 5's correctness gates (the speed against cuDNN and
   the bounds printed, not gated), phase 6's launches a step; (b) the
   data-parallel step in sync mode in an NCCL group of one, 2 steps from
   phase 6's init with its BatchNorms perturbed (``perturb_bn``) and B=2
   batch, bit-equal to the plain step (losses, parameters, running
   statistics), its collectives a step; (c) two processes on the one card
   over gloo (NCCL refuses two ranks on one card), each B=1 of that
   batch, 2 steps: sync mode within the DP_* gates of the one-process B=2
   step (the same step with its frames swapped held to them too), both
   ranks bit-equal, the BatchNorms' all-reduce with its backward keeping
   none, or DP_FAULT_KEPT, of the other rank's cotangent rejected by the
   same gates,
   localbn within DP_LOCAL_TOL of the mean of two one-process B=1 steps
   and one update of their mean gradient, each rank's launches, collectives,
   median step ms and peak memory; (d) ``tools.train`` from 16 files, an
   epoch of 2 steps, then ``--resume``, and ``tools.test`` from 2
   validation files, each under ``python -m torch.distributed.run
   --standalone --nproc_per_node 1`` with ``--multihost`` (NCCL);
13. width sharding of ``rangedet_veh_wo_aug_4_18e`` at 64x2656 (a "model"
   mesh axis, ``parallel/halo.py``): (a) the width ops in a width group of
   one against the unsharded ops (the conv and deconv outputs and input
   gradients bit-equal), one width step on 64x1328 (the first frame from
   SEED on with a box across the seam) with every launch through phase
   5's correctness gates and kernel 7's (speed printed, not gated), and
   the floor: the width step in a group of one on the whole frame against
   the plain step; (b) two gloo ranks on the one card, --mesh model=2,
   each 64x1328 of that frame, 2 steps from [12]'s weights against the
   plain step on the frame: losses and updates within the W_* gates,
   step 1's targets on the ranks' columns bit-equal to the frame's, the
   width ops on the ranks' columns against the unsharded ops (W_OP_TOL),
   both ranks bit-equal, the collectives a step as the model implies them,
   three planted faults (the forward's halos zero, the backward dropping
   the returned halo gradient, the point counts not summed over the width
   group) rejected by those gates, each rank's launches, median and peak,
   and near the seam the outputs' and feature gradients' spread, printed;
   (c) ``tools.train --mesh data=2,model=2`` on four gloo ranks on
   the card under ``python -m torch.distributed.run`` from 16 files: an
   epoch of 2 steps with --gspmd-width, --resume --eval-every 1; the
   ranks of a data group on the same frames, all ranks bit-equal; a mesh
   whose shards are not phase-aligned refused.

14. the user's chain from raw frames on ``rangedet_veh_wo_aug_4_18e`` at
   64x2650: (a) 2 training segments and 1 validation segment of 4
   duck-typed Waymo frames (``waymo_frames``: vehicles placed in the
   vehicle frame, raytraced in the sensor frame of a lidar with a yaw of
   BUILD_YAW and a roof mount, in Waymo's column convention) through
   ``data/waymo_builder.py`` on the card and on the CPU: range image,
   inclination, azimuth and roidb equal, pc_vehicle_frame within
   BUILD_PC_ULPS, every rendered box pixel back within BOX_TOL of its box
   in the vehicle frame, the builder's ms a frame with the npz write
   apart; then ``tools.train --data-root <built> --epochs 1`` (4 steps of
   B=2, launches 4 x [6]'s per step, the ``params:`` line), ``--epochs 2
   --resume --eval-every 1``, ``tools.test`` on the 4 validation frames,
   ``create_prediction_bin_3d`` (every detection exported) and
   ``evaluate_pred`` (finite, 4 frames); (b) 4 synthesized KITTI scans of
   120,000 points through ``tools.create_range_image_in_kitti`` on the
   card and the CPU: the images equal but at pixels of points within
   EDGE_BAND of a row or column boundary (counted), the ties at the
   nearest range counted, a farther point planted last on an occupied
   pixel losing it, points-in-box counts equal but for points within
   FACE_BAND of a face, the range image's ms a scan; one train step
   ([6]'s launches) and one eval step on two KITTI records padded to the
   pad field; (c) the train CLI's device prefetch: epoch 0's metrics
   bit-equal to the same steps on the same batches after a synchronous
   copy, and under torch.profiler the batch copies on a stream other
   than the step's, overlapping its kernels; data_ms and step_ms.

With ``--rank-worker SPEC`` the script is one rank of [12](c) or [13](b)
(``rank_main``), started by ``start_ranks``; with ``--cli-rank OUT CLI
ARGS`` one rank of ``tools.train`` or ``tools.test`` under a launcher
([13](c), ``cli_rank_main``); the CPU tests start both.

It prints a JSON line of the kernels, one entry per kernel and path (the
serving forward of phases 2-3 and 7, the train step of phases 5-6, the IoU
target on the multiclass step of phase 8 as ``"train_multiclass"``, the
Meta-Kernel kernels at C=128 of phase 9 as ``"train_tpuopt"`` and
``"serve_tpuopt"``, the train kernels at B=1 of phase 12 as
``"train_b1"``, their launches a rank's step of [12](c); rows 1, 1b, 2,
6 and 7 at [13](a)'s width shapes as ``"train_width"``, their launches a
rank's step of [13](b)), with
the card's name and power limit on the line before it, then as its last
line ``{"ok": true, "device": {...}}``. Every kernel, plain and
cuDNN time in it is the median of 5 timings of 10 calls by CUDA events
(plain Meta-Kernel versions: of 3 calls). bound_ms is the least time of
the work as the kernel does it: for the Meta-Kernel kernels, which run
their contractions on the tensor cores, the tensor-core bound
(profile_meta.tc_bound_ms), with the f32-FFMA bound that their speed
gates read beside it as f32_bound_ms. Without CUDA it exits non-zero.
"""
import contextlib
import copy
import io
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

RECIPE = "rangedet_veh_wo_aug_4_18e"
# phase 8: the three-class recipe, trained with host augmentation
MULTICLASS = "rangedet_multiclass_all_36e"
# phase 9: the wide-channel recipe, whose Meta-Kernel block is C=128
TPUOPT = "rangedet_veh_tpuopt_all_36e"
SEED = 0
# |y - ref| <= REL_TOL * |ref| + MAX_TOL * max|ref|, ref in f32 from the same
# bf16 operands: the kernel accumulates in f32 and rounds once to bf16
REL_TOL = 2.0 ** -6
MAX_TOL = 1e-3
# f32 results of a kernel (channel sums, dscale/dbias, wgrad) against the
# plain version's: the same f32 products summed in another order over up
# to B*H*W = 340k terms; max|a - b| <= F32_SUM_TOL * max|b|
F32_SUM_TOL = 1e-3
# gradients through the autograd Function (stride 2, deconv), kernel vs
# plain: bf16 outputs one rounding (2^-8 relative) apart at most, so
# max|a - b| <= 2^-6 max|b| leaves a factor of 4
FN_TOL = 2.0 ** -6
# IoU target, kernel vs plain: the same f32 operations (-fmad=false) but
# expf, which may differ from the host's by 2 ulp in the box size
IOU_TOL = 1e-5
# kernel path vs plain path, whole model: max|a - b| / max|b| per output
MODEL_TOL = 5e-2
# train step on step 1, kernel path vs plain path, both bf16 (measured,
# PERF.md). At random init the bf16 BatchNorm backward cancels: the
# per-parameter gradients of either bf16 path lie a median 0.87 max|g|
# from an f32 step, so no per-tensor bound holds for a correct kernel.
# The gates, each on r = max|a - b| / max|b| per parameter: each loss
# |a - b| / |b| <= LOSS_TOL; the 1x1 head projections, whose gradients see
# no BatchNorm backward, r <= HEAD_GRAD_TOL (measured 0.104; either bf16
# path lies 0.19-0.21 from f32 there); the median r over all parameters
# <= MEDIAN_TOL and over the 3x3 conv weights (the wgrad kernel's output)
# <= CONV_MEDIAN_TOL. Phase 6 plants a zeroed dgrad and a sign-flipped
# wgrad and shows the gates reject both. Measured medians on the recipe's
# step (fused Meta-Kernel block), all / conv: sound 0.629 / 0.624, zeroed
# dgrad 1 / 1, flipped wgrad 0.794 / 1.937; each limit lies midway between
# the sound reading and the nearer fault's. The fused step's step-1 losses
# against the materialized block's step: within LOSS_TOL too
LOSS_TOL = 1e-2
HEAD_GRAD_TOL = 0.14
MEDIAN_TOL = 0.71
CONV_MEDIAN_TOL = 0.81
STEPS_PER_EPOCH = 100
# the wgrad kernel summed over one B=2 step against cuDNN's conv2d_weight
# at the same shapes, in the same run: at most this factor (the earlier
# mma.sync kernel read 12.4, this one about 1.6; PERF.md)
WGRAD_CUDNN_MAX = 4.0
# the same for the forward kernel, summed over the B=2 step and over the
# B=1 eval forward (cuDNN's conv2d), and for the dgrad (conv2d_input); the
# mma.sync kernel before the TMA + wgmma one read 8.3, 6.6 and 2.5
FWD_CUDNN_MAX = 4.0
DGRAD_CUDNN_MAX = 1.5
# kernel 7 against the plain version in bf16 (the XLA form's counterpart):
# JAX's own bound between the TPU kernel and that form
# (tests/test_meta_kernel.py), |a - b| <= TAPS_TOL * (1 + |b|). Where the
# bf16 form's own rounding (h and w to bf16, then the product) puts it
# outside, the kernel must be the nearer of the two to the f32 reference
TAPS_TOL = 4e-2
# full-size frames of the dataset path, 64 x 2650: the training split,
# the validation split, and the batch of tools.test
FILE_FRAMES = 8
VAL_FRAMES = 2
FILE_BATCH = 4
# the H100 SXM's published peaks (NVIDIA data sheet) for bound_ms
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# the IoU target's clip (its kernel and clean pass) summed over one B=2
# step against its bound (profile_iou.iou_work at PEAK_F32, over the
# ceil(nv/8)*8 candidates a block that the candidate contract runs): at
# most this factor. The first port's kernel, one block per 2048-pixel
# block, read 20x
IOU_CLIP_BOUND_MAX = 10.0
# the Meta-Kernel block's kernels summed over one B=2 step against their
# f32-FFMA bound (meta_work at PEAK_F32), in the same run: at most these
# factors. The FFMA kernels before the tensor-core ones read 6.5x and 4.8x
META_BWD_BOUND_MAX = 3.5
META_AGG_BOUND_MAX = 3.0
# meta_stats over the step and kernel 7 per eval forward (B=4 and B=1),
# the same; their FFMA kernels read 4.2x and 4.9x
META_STATS_BOUND_MAX = 3.0
META_TAPS_BOUND_MAX = 3.0
# kernel 7 against the training plain version's tap product a on
# meta_stats' inputs: a is rounded mid-way, and the plain f32 wt's order
# (cuBLAS's, unstated) may differ from the kernels' near a bf16 tie, so at
# most this share of the elements may differ, each by one bf16 ulp. And
# meta_stats' (sum a, sum a^2) against float64 sums of kernel 7's output:
# |s - ref| <= TAP_SUM_TOL * (sum |a| resp. sum a^2) per channel, f32 sums
# of ~340k terms in another order
TAP_OFF_MAX = 1e-4
TAP_SUM_TOL = 1e-5
# the weighted-NMS kernel's f32 operations a (member, candidate) pair of
# the blocked form: the BEV IoU (two Liang-Barsky clips of 16 half-plane
# tests each, the edge sums, areas and the ratio), as profile_iou counts
# the same clip. Charged to every member of every round against every
# candidate, it is an upper count: the function needs only each survivor
# against the candidates alive at its turn, and the kernel computes the
# IoU only of the pairs past its circumcircle filter
WNMS_OPS_PER_PAIR = 600
# phase 10's CLI run: training frames (B=2: 8 steps an epoch), the
# recipe's options, the speedometer's frequency; AdamWS's standardized
# kernels within STD_TOL of mean 0 / std 1 a filter after each step
CLI_FRAMES = 16
LOG_FREQ = 4
STD_TOL = 1e-4
CLI_RECIPE = """from rangedet_tpu_torch.configs import load_config


def get_config(is_train):
    return load_config({recipe!r}, is_train).replace(
        optimizer="adamws", lr_mode="onecycle", clip_mode="global_norm",
        remat=True, log_frequency={freq})
"""


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _time_ms(fn, iters=10, warmup=2, reps=5):
    """The median of reps means of fn()'s ms over iters launches, by CUDA
    events: one slow stretch of the host or the clocks moved a single mean
    of 10 calls of kernel 7 at B=1 (~0.25 ms) by 12%."""
    import torch

    for _ in range(warmup):
        fn()
    means = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means)


def _median_ms(fn, iters=10, warmup=2):
    """Median host ms of fn() with a synchronize on each side."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _bound_ms(flops, nbytes, peak):
    """Least time for the work: operations at the peak rate or bytes at
    the memory rate, whichever is longer; and which of the two it is."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def conv_launches(cfg):
    """conv3x3 forward launches per forward pass that the config implies,
    and how they add up."""
    from rangedet_tpu_torch.models.dla_backbone import DEFAULT_NUM_BLOCK

    n_meta = meta_units(cfg)
    n_blocks = sum((cfg.num_block or DEFAULT_NUM_BLOCK).values())
    n_levels = len(cfg.fpn_strides)
    n = (2 * n_blocks - n_meta + 4
         + n_levels * (cfg.cls_conv_layers + cfg.reg_conv_layers))
    return n, (f"2*{n_blocks} block convs - {n_meta} Meta-Kernel conv1 + 4 "
               f"agg deconvs + {n_levels}*({cfg.cls_conv_layers}+"
               f"{cfg.reg_conv_layers}) head = {n}")


def meta_units(cfg):
    """The number of Meta-Kernel blocks the config builds."""
    from rangedet_tpu_torch.models.dla_backbone import DEFAULT_META_UNITS

    return len(DEFAULT_META_UNITS if cfg.meta_units is None
               else cfg.meta_units)


def train_launches(cfg, tag):
    """The launches of one train step that the config implies, by kernel;
    prints how they add up."""
    n_levels = len(cfg.fpn_strides)
    n_fwd = conv_launches(cfg)[0]
    n_meta = meta_units(cfg) if cfg.use_pallas_meta else 0
    expected = {"fwd": n_fwd, "dgrad": n_fwd - 1, "wgrad": n_fwd,
                "iou": n_levels * cfg.num_classes,
                "iou_prep": n_levels * cfg.num_classes, "meta_stats": n_meta,
                "meta_agg": n_meta, "meta_block_bwd": 2 * n_meta,
                "meta_kernel_taps": 0}
    print(f"[{tag}] expected launches per step: forward {n_fwd} (as the "
          f"eval forward), dgrad {n_fwd - 1} (all but res1_unit1.conv1, "
          f"whose input is the data), wgrad {n_fwd}, IoU target {n_levels} "
          f"levels x {cfg.num_classes} classes = {expected['iou']} (one prep "
          f"and one clip launch each); per fused "
          f"Meta-Kernel block ({n_meta}) one meta_stats, one meta_agg, two "
          f"meta_block_bwd (one per mode); no taps kernel (eval only)")
    return expected


def reset_counts(m):
    """Every kernel wrapper's launch count to 0."""
    for k in ("conv3x3", "iou", "meta", "taps"):
        m[k].reset_counts()


def read_counts(m):
    """The launch counts of every kernel wrapper, by kernel."""
    conv3x3, iou_mod, meta, taps = m["conv3x3"], m["iou"], m["meta"], m["taps"]
    return {"fwd": conv3x3.LAUNCHES, "dgrad": conv3x3.DGRAD_LAUNCHES,
            "wgrad": conv3x3.WGRAD_LAUNCHES, "iou": iou_mod.LAUNCHES,
            "iou_prep": iou_mod.PREP_LAUNCHES,
            "meta_stats": meta.STATS_LAUNCHES, "meta_agg": meta.AGG_LAUNCHES,
            "meta_block_bwd": meta.BWD_LAUNCHES,
            "meta_kernel_taps": taps.LAUNCHES}


def ptxas_report(log, kernel):
    """Registers and spills of the entry functions whose mangled names
    contain ``kernel`` (every instantiation of a template, or one, as
    ``name<0>`` is ``nameILi0E``), from an ``nvcc -Xptxas -v`` log."""
    found, spill, regs = False, None, []
    spills = set()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = kernel in line
        elif found and "spill stores" in line:
            spill = line.strip()
        elif found and "Used" in line and "registers" in line:
            regs.append(int(line.split("Used", 1)[1].split("registers")[0]))
            spills.add(spill)
            found = False
    if not regs:
        return "not in this run's build log (library built earlier)"
    ignored = "setmaxnreg ignored" in log
    n = f"{len(regs)} instantiations, " if len(regs) > 1 else ""
    return (f"{n}{min(regs)}-{max(regs)} registers at launch, setmaxnreg "
            f"{'IGNORED' if ignored else 'applied'}; "
            + " / ".join(sorted(s for s in spills if s)))


def conv_device(fn, flops, sums, n):
    """The device time of one call of the forward/dgrad kernel split into
    its prologue, GEMM and reduction (profile_conv.device_ms), added n
    times into ``sums``; a line of text."""
    from rangedet_tpu_torch.tools.profile_conv import device_ms

    split = device_ms(fn)
    if split is None:
        return "device time not measured (the profiler saw no GEMM)"
    for k, v in split.items():
        sums[k] = sums.get(k, 0.0) + n * v
    sums["measured"] = sums.get("measured", 0) + n
    return (f"device prologue {split['prologue']:.4f} + GEMM "
            f"{split['gemm']:.4f} + reduce {split['reduce']:.4f} ms (GEMM "
            f"{flops / split['gemm'] / 1e9:.1f} TFLOP/s)")


def conv_gate(tag, name, t, split, limit):
    """Print the kernel's sum over the launches against cuDNN's and its
    device split; fail beyond ``limit`` x cuDNN (None: no gate)."""
    from rangedet_tpu_torch import _build

    dev = sum(split.get(k, 0.0) for k in ("prologue", "gemm", "reduce"))
    print(f"[{tag}] {name}: kernel {t.ms:.3f} ms / cuDNN {t.library_ms:.3f} "
          f"ms = {t.ms / t.library_ms:.2f}x (limit "
          f"{limit or 'none, printed only'}); bound "
          f"{t.bound_ms:.3f} ms = {t.bound_ms / t.ms:.1%} of the kernel's "
          f"time; device time (profiler) over {split.get('measured', 0)} of "
          f"the {t.n} launches {dev:.3f} ms: prologue "
          f"{split.get('prologue', 0.0):.3f}, GEMM {split.get('gemm', 0.0):.3f}"
          f", reduce {split.get('reduce', 0.0):.3f}; GEMM kernel (ptxas) "
          f"{ptxas_report(_build.build_log, 'conv3x3_gemm_kernel')}")
    if limit is not None and not t.ms <= limit * t.library_ms:
        raise SystemExit(f"[{tag}] {name} takes {t.ms / t.library_ms:.2f}x "
                         f"cuDNN, more than {limit}x")


def _rel(a, b):
    """max|a - b| / max|b|."""
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp(min=1e-30)).item()


def _bf16_ok(y, ref):
    err = (y.float() - ref).abs()
    ok = bool((err <= REL_TOL * ref.abs() + MAX_TOL * ref.abs().max()).all())
    return ok and bool(y.float().isfinite().all()), err.max().item()


class KernelTotals:
    """Sums over the launches of a kernel in one step or forward: count,
    kernel ms, plain ms, bound ms, cuDNN ms; and the largest error."""

    def __init__(self):
        self.n = 0
        self.ms = self.plain_ms = self.bound_ms = self.library_ms = 0.0
        self.err = 0.0
        self.by = {}
        # rows 3-5, 7: the f32-FFMA bound of the speed gates (bound_ms is
        # the tensor-core bound)
        self.f32_bound_ms = 0.0
        self.extra = {}  # more keys of the kernels line

    def add(self, n, ms, plain_ms, bound, library_ms, err):
        self.n += n
        self.ms += n * ms
        self.plain_ms += n * plain_ms
        self.bound_ms += n * bound[0]
        self.by[bound[1]] = self.by.get(bound[1], 0.0) + n * bound[0]
        if library_ms is not None:
            self.library_ms += n * library_ms
        self.err = max(self.err, err)

    def bound_by(self):
        return max(self.by, key=self.by.get) if self.by else "operations"


def wnms_check(torch, nms, args, kw, tag="3"):
    """The weighted-NMS kernel on one call's (F, K, 11) candidates against
    the plain version on the card: validity, the score column (bit for
    bit) and the rounds a frame (the plain version's wnms.round ranges,
    each frame alone at its own keep cap, the rows past it zero and
    invalid) equal; the 11 averaged values within the bound of
    two f32 weighted means of the same m products summed in other orders
    (tests/test_torch_wnms_plan.py:mean_gap_bound), taken here with m the
    frame's valid candidates and each product at most the weight times the
    column's largest |value| among them (a NaN as any NaN); then kernel
    and plain ms and the f32 bound of the blocked form's pair IoUs.
    Returns a KernelTotals."""
    rows, valid = nms.weighted_nms(*args, **kw)
    rounds = nms.wnms_kernel(*args, **kw)[2].tolist()
    u, gap_share = 2.0 ** -24, 0.0
    caps = kw["max_keep"]
    caps = [caps] if isinstance(caps, int) else list(caps)
    for f, one in enumerate(zip(*args)):
        n = [0]
        real = nms.span

        def count(name):
            n[0] += name == "wnms.round"
            return real(name)

        cap = caps[f % len(caps)]
        with mock.patch.object(nms, "span", count):
            want, want_valid = nms.weighted_nms_plain(
                *one, **dict(kw, max_keep=cap))
        if valid[f, cap:].any() or rows[f, cap:].any():
            raise SystemExit(f"[{tag}] WNMS kernel, frame {f}: rows past "
                             f"its cap {cap} not zero and invalid")
        m = int(one[2].sum())
        e = (m + 1) * u
        scale = one[0][one[2]].abs().amax(dim=0) if m else torch.zeros_like(
            one[0][0])
        tol = (2 * (2 * e + u) * scale.double() / (1 - e) ** 2)
        x, y = rows[f, :cap, :11].double(), want[:, :11].double()
        nan = torch.isnan(x)
        gap = torch.where(nan | (x == y), 0.0, (x - y).abs())
        gap_share = max(gap_share, float((gap / tol).nan_to_num().max()))
        same = (torch.equal(valid[f, :cap], want_valid)
                and torch.equal(nan, torch.isnan(y))
                and bool((gap <= tol).all())
                and torch.equal(rows[f, :cap, 11].view(torch.int32),
                                want[:, 11].view(torch.int32)))
        if not same or rounds[f] != n[0]:
            raise SystemExit(f"[{tag}] WNMS kernel vs plain, frame {f}: "
                             f"validity, scores and values within bound "
                             f"{same}, rounds {rounds[f]} vs {n[0]}")
    t = KernelTotals()
    F_, K = args[0].shape[:2]
    flops = WNMS_OPS_PER_PAIR * sum(rounds) * min(kw["block"], K) * K
    nbytes = 4 * F_ * K * 13 + 4 * rows.numel() + valid.numel()
    t.add(1, _time_ms(lambda: nms.weighted_nms(*args, **kw)),
          _median_ms(lambda: nms.weighted_nms_plain(*args, **kw), iters=3),
          _bound_ms(flops, nbytes, PEAK_F32), None, 0.0)
    print(f"[{tag}] WNMS kernel at F={F_}, K={K}, keep caps {caps}: "
          f"validity, scores and rounds "
          f"{rounds} equal to the plain version's, values within their "
          f"bound (largest gap/bound {gap_share:.3g}); kernel "
          f"{t.ms:.4f} ms, "
          f"plain {t.plain_ms:.2f} ms, f32 bound {t.bound_ms:.4f} ms "
          f"({t.bound_by()})")
    return t


# ---------------------------------------------------------------- phase 5
def clone_view(t):
    """A copy of t's whole storage, viewed as t views it: the same shape,
    strides and storage offset. (clone() makes a view that is not dense,
    such as class k's channels of the head's deltas at K > 1, contiguous.)"""
    n = t.untyped_storage().nbytes() // t.element_size()
    return t.as_strided((n,), (1,), 0).clone().as_strided(
        t.shape, t.stride(), t.storage_offset())


def record_train_step(step, batch, conv3x3, iou_mod, layers, meta):
    """Run step(batch) once, counting every distinct kernel call shape, and
    keeping the real inputs of the IoU target and of the Meta-Kernel block's
    kernels."""
    fwd, dgrad, wgrad, deconv, iou = {}, {}, {}, {}, []
    metas = {"stats": [], "agg": [], "bwd": []}
    real_f, real_d, real_w = (conv3x3.conv3x3_bhcw, conv3x3.conv3x3_dgrad,
                              conv3x3.conv3x3_wgrad)
    real_i, real_dc = iou_mod.iou_target, layers.deconv_bhcw
    real_ms, real_ma, real_mb = meta.meta_stats, meta.meta_agg, meta.meta_bwd

    def count(d, key):
        d[key] = d.get(key, 0) + 1

    def rec_f(x, w, scale=None, bias=None, stride_w=1, stats=False):
        count(fwd, (x.shape[0], x.shape[2], w.shape[3], x.shape[3], stride_w,
                    scale is not None, stats))
        return real_f(x, w, scale, bias, stride_w, stats)

    def rec_d(gy, w, cot=None, affine=None):
        count(dgrad, (gy.shape[0], gy.shape[2], w.shape[2], gy.shape[3],
                      cot is not None, affine is not None))
        return real_d(gy, w, cot, affine)

    def rec_w(x, gy, scale=None, bias=None, cot=None):
        count(wgrad, (x.shape[0], x.shape[2], gy.shape[2], x.shape[3],
                      scale is not None, cot is not None))
        return real_w(x, gy, scale, bias, cot)

    def rec_i(d, p, gt, topk_gt=32):
        # copies with the head's layout: the kernels read the views' strides
        iou.append((clone_view(d), clone_view(p), gt.clone(), topk_gt))
        return real_i(d, p, gt, topk_gt)

    def rec_dc(x, weight, stride_w):
        count(deconv, (x.shape[0], x.shape[2], weight.shape[1], x.shape[3],
                       stride_w))
        return real_dc(x, weight, stride_w)

    def clone(a):
        if isinstance(a, tuple):
            return tuple(clone(e) for e in a)
        return a.detach().clone() if hasattr(a, "detach") else a

    def keep(kind, real):
        def rec(*args):
            metas[kind].append(clone(args))
            return real(*args)
        return rec

    with mock.patch.object(conv3x3, "conv3x3_bhcw", rec_f), \
            mock.patch.object(conv3x3, "conv3x3_dgrad", rec_d), \
            mock.patch.object(conv3x3, "conv3x3_wgrad", rec_w), \
            mock.patch.object(iou_mod, "iou_target", rec_i), \
            mock.patch.object(layers, "deconv_bhcw", rec_dc), \
            mock.patch.multiple(meta, meta_stats=keep("stats", real_ms),
                                meta_agg=keep("agg", real_ma),
                                meta_bwd=keep("bwd", real_mb)):
        step(batch)
    return fwd, dgrad, wgrad, deconv, iou, metas


def _plain_convs(conv3x3, plain=True, meta=None):
    """A context in which the conv Function (and, given ``meta``, the
    Meta-Kernel block's Functions) runs the plain versions (or, with
    plain=False, the kernels as usual)."""
    stack = contextlib.ExitStack()
    if plain:
        stack.enter_context(mock.patch.multiple(
            conv3x3, conv3x3_bhcw=conv3x3.conv3x3_bhcw_plain,
            conv3x3_dgrad=conv3x3.conv3x3_dgrad_plain,
            conv3x3_wgrad=conv3x3.conv3x3_wgrad_plain))
    if plain and meta is not None:
        stack.enter_context(mock.patch.multiple(
            meta, meta_stats=meta.meta_stats_plain,
            meta_agg=meta.meta_agg_plain, meta_bwd=meta.meta_bwd_plain))
    return stack


def one_tap_product(torch, meta, taps, args, fail, tag="5"):
    """Kernel 7 on the arguments of a meta_stats launch against the
    training plain version's a, and meta_stats' sums against float64 sums
    of kernel 7's output."""
    from rangedet_tpu_torch.tools.profile_meta import training_taps, ulps

    a7 = taps.meta_kernel_taps(*args)
    s1, s2 = meta.meta_stats(*args)
    torch.cuda.synchronize()
    d = ulps(a7, training_taps(*args))
    n_off, d_max, n = int((d > 0).sum()), int(d.max()), d.numel()
    del d
    C9 = a7.shape[2]
    a = a7.double().permute(2, 0, 1, 3).reshape(C9, -1)
    del a7
    r1, r2, m1 = a.sum(1), (a * a).sum(1), a.abs().sum(1)
    del a
    e1 = ((s1.double() - r1).abs() / m1.clamp(min=1e-300)).max().item()
    e2 = ((s2.double() - r2).abs() / r2.clamp(min=1e-300)).max().item()
    ok1 = bool(((s1.double() - r1).abs() <= TAP_SUM_TOL * m1).all())
    ok2 = bool(((s2.double() - r2).abs() <= TAP_SUM_TOL * r2).all())
    print(f"[{tag}] one tap product: kernel 7 on meta_stats' inputs differs "
          f"from "
          f"the training plain version's a at {n_off} of {n} elements "
          f"({n_off / n:.3g}; limit {TAP_OFF_MAX}), by at most {d_max} bf16 "
          f"ulp; meta_stats' sums against float64 sums of kernel 7's output,"
          f" per channel: |s1 - ref| / sum|a| {e1:.3g}, |s2 - ref| / sum a^2 "
          f"{e2:.3g} (limit {TAP_SUM_TOL})")
    if d_max > 1 or n_off > TAP_OFF_MAX * n:
        fail(f"kernel 7's a differs from the training plain version's at "
             f"{n_off} elements, by up to {d_max} ulp")
    if not (ok1 and ok2):
        fail(f"meta_stats' sums are not kernel 7's a: {e1:.3g}, {e2:.3g}")


def iou_call(torch, iou_mod, call, **plain_timing):
    """One IoU-target call on the inputs a step gave it: its gates
    (profile_iou.check: error against the plain version, finite, the prep's
    rows off the plain prep's, a bit-equal repeat), its output, pairs, and
    bounds (profile_iou.iou_work), and the ms of the kernels, the prep, the
    clip and the plain version (timed with ``plain_timing``)."""
    from rangedet_tpu_torch.tools.profile_iou import bound_ms, check, iou_work

    d, p, gt, topk = call
    err, finite, off, same, cand, nv = check(call)
    out = iou_mod.iou_target(d, p, gt, topk)
    work, pairs, live_pairs = iou_work(d, gt, nv, cand.shape[1])
    scratch = torch.zeros_like(out)
    return dict(
        err=err, finite=finite, off=off, same=same, cand=cand, nv=nv,
        out=out, pairs=pairs, live_pairs=live_pairs,
        bound=bound_ms(*work["all"]), clip_bound=bound_ms(*work["clip"])[0],
        live_bound=bound_ms(*work["clip_live"])[0],
        ms=_time_ms(lambda: iou_mod.iou_target(d, p, gt, topk)),
        prep_ms=_time_ms(lambda: iou_mod.candidates(d, p, gt, topk)),
        clip_ms=_time_ms(lambda: iou_mod.clip(cand, nv, d, p, scratch)),
        plain_ms=_time_ms(lambda: iou_mod.iou_target_plain(d, p, gt, topk),
                          **plain_timing))


def add_iou(t, r):
    """Add one iou_call result into the KernelTotals ``t`` and its extra
    keys: the prep and clip ms, the clip's bounds over the contract's
    padded pairs and over live pairs."""
    t.add(1, r["ms"], r["plain_ms"], r["bound"], None, r["err"])
    for key, v in (("prep_ms", r["prep_ms"]), ("clip_ms", r["clip_ms"]),
                   ("clip_bound_ms", r["clip_bound"]),
                   ("clip_live_bound_ms", r["live_bound"])):
        t.extra[key] = t.extra.get(key, 0.0) + v


def phase5_iou(torch, iou_mod, iou, t, tag="5", speed_gates=True):
    """The IoU target's gates and times on the calls the step made, one per
    level and class, summed into the KernelTotals ``t``. Without
    ``speed_gates`` the clip's time against its bound is printed, not
    gated."""
    from rangedet_tpu_torch import _build

    def fail(msg):
        raise SystemExit(f"[{tag}] {msg}")

    t.extra["before_ms"] = 0.0
    for lvl, call in enumerate(iou):
        d, p, gt, topk = call
        r = iou_call(torch, iou_mod, call, iters=3)
        print(f"[{tag}] IoU target level {lvl}: deltas {tuple(d.shape)} strides "
              f"{d.stride()}, {r['nv'].numel()} blocks, G="
              f"{r['cand'].shape[1]}, nv sum {int(r['nv'].sum())}, max abs "
              f"err {r['err']:.3g} (limit {IOU_TOL}); "
              f"blocks whose prep output differs from the plain prep's: "
              f"in nv {r['off'][0]}, in a live row's corners {r['off'][1]}, "
              f"in a live row's area bits alone {r['off'][2]}; bit-equal "
              f"repeat {r['same']}")
        if not (r["err"] <= IOU_TOL and r["finite"]):
            fail(f"IoU target disagrees at level {lvl}: max err {r['err']}")
        if not r["same"]:
            fail(f"IoU target not reproducible at level {lvl}")

        def before():
            # the old path's prep (the plain prep in torch ops, as the
            # card ran it before the prep kernel) and this clip: the first
            # port's clip kernel is no longer in the tree
            # (tools/profile_iou.py --against times the whole old path)
            c, n, _, _ = iou_mod.prepare_candidates(d, p, gt, topk)
            return iou_mod.clip(c, n, d, p, torch.zeros_like(r["out"]))

        before_ms = _time_ms(before)
        add_iou(t, r)
        t.extra["before_ms"] += before_ms
        print(f"[{tag}] IoU target level {lvl}: {r['pairs']} (pixel, candidate) "
              f"pairs ({r['live_pairs']} live), {int((r['out'] > 0).sum())} "
              f"pixels with IoU > 0; kernels {r['ms']:.4f} ms (prep "
              f"{r['prep_ms']:.4f}, clip {r['clip_ms']:.4f}), the old prep "
              f"with this clip {before_ms:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms; bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), the "
              f"clip's {r['clip_bound']:.4f} ms")
    x = t.extra
    clip_x = x["clip_ms"] / x["clip_bound_ms"]
    print(f"[{tag}] IoU target over the step: prep {x['prep_ms']:.4f} ms + "
          f"clip {x['clip_ms']:.4f} ms; the old prep with this clip "
          f"{x['before_ms']:.4f} ms; the clip at {clip_x:.2f}x its bound "
          f"{x['clip_bound_ms']:.4f} ms (limit "
          f"{IOU_CLIP_BOUND_MAX if speed_gates else 'none, printed only'}), "
          f"{x['clip_ms'] / x['clip_live_bound_ms']:.2f}x its bound over "
          f"live pairs {x['clip_live_bound_ms']:.4f} ms; clip kernel (ptxas) "
          f"{ptxas_report(_build.build_log, 'iou_clip_kernel')}; prep kernel "
          f"(ptxas) {ptxas_report(_build.build_log, 'iou_prep_kernel')}")
    if speed_gates and not clip_x <= IOU_CLIP_BOUND_MAX:
        fail(f"the IoU clip takes {clip_x:.2f}x its bound, more than "
             f"{IOU_CLIP_BOUND_MAX}x")


def _channels_last(t):
    import torch

    return t.permute(0, 2, 1, 3).contiguous(memory_format=torch.channels_last)


def conv_fwd_case(torch, conv3x3, key, H, rn, vecs, fail):
    """One conv3x3 forward shape (B, Ci, Co, W, stride, ingest, stats) of a
    step on seeded inputs: the kernel against the plain version (the bf16
    gate; with stats, its sums against float64 sums of its own y), a
    bit-equal repeat, the kernel, plain and cuDNN ms and the bound. Returns
    (max err, kernel ms, plain ms, cuDNN ms, bound, the kernel's call)."""
    B, Ci, Co, W, s, ingest, stats = key
    x = rn(B, H, Ci, W).bfloat16()
    w = (rn(3, 3, Ci, Co) / (3.0 * Ci ** 0.5)).bfloat16()
    sc, bi = vecs(Ci) if ingest else (None, None)
    out = conv3x3.conv3x3_bhcw(x, w, sc, bi, s, stats)
    torch.cuda.synchronize()
    y = out[0] if stats else out
    ref = conv3x3.conv3x3_bhcw_plain(x, w, sc, bi, s, out_dtype=torch.float32)
    ok, err = _bf16_ok(y, ref)
    if stats:  # the kernel's sums against its own stored y, in f64
        yd = y.double()
        ok &= _rel(out[1], yd.sum((0, 1, 3))) <= F32_SUM_TOL
        ok &= _rel(out[2], (yd * yd).sum((0, 1, 3))) <= F32_SUM_TOL
    if not ok:
        fail(f"conv3x3 forward disagrees at {key}: max err {err}")
    call = lambda: conv3x3.conv3x3_bhcw(x, w, sc, bi, s, stats)  # noqa: E731
    k_ms = _time_ms(call)
    p_ms = _time_ms(lambda: conv3x3.conv3x3_bhcw_plain(x, w, sc, bi, s,
                                                       stats))
    xn = _channels_last(x)
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    c_ms = _time_ms(lambda: torch.nn.functional.conv2d(
        xn, wn, stride=(1, s), padding=1))
    Wo = W // s
    bound = _bound_ms(2 * B * H * Wo * Co * Ci * 9,
                      2 * (B * H * Ci * W + 9 * Ci * Co + B * H * Co * Wo),
                      PEAK_BF16)
    again = call()
    if not torch.equal(y, again[0] if stats else again):
        fail(f"conv3x3 forward repeat differs at {key}")
    return err, k_ms, p_ms, c_ms, bound, call


def conv_dgrad_case(torch, conv3x3, key, H, rn, vecs, fail):
    """One dgrad shape (B, Cgy, Cdx, W, cot, affine) of a step, as
    conv_fwd_case: the bf16 gate on dx, with the affine backward its f32
    dscale/dbias, a bit-equal repeat, the times and the bound."""
    B, Cg, Cx, W, cot, aff = key
    gy = rn(B, H, Cg, W).bfloat16()
    w = (rn(3, 3, Cx, Cg) / (3.0 * Cx ** 0.5)).bfloat16()
    cots = affs = None
    if cot:
        cots = (rn(B, H, Cg, W).bfloat16(), rn(Cg, scale=0.1),
                rn(Cg, scale=0.05))
    if aff:
        affs = (rn(B, H, Cx, W).bfloat16(), *vecs(Cx))
    out = conv3x3.conv3x3_dgrad(gy, w, cots, affs)
    torch.cuda.synchronize()
    ref = conv3x3.conv3x3_dgrad_plain(gy, w, cots, affs,
                                      out_dtype=torch.float32)
    ok, err = _bf16_ok(out[0] if aff else out, ref[0] if aff else ref)
    if aff:
        ok &= _rel(out[1], ref[1]) <= F32_SUM_TOL
        ok &= _rel(out[2], ref[2]) <= F32_SUM_TOL
    if not ok:
        fail(f"dgrad disagrees at {key}: max err {err}")
    call = lambda: conv3x3.conv3x3_dgrad(gy, w, cots, affs)  # noqa: E731
    k_ms = _time_ms(call)
    p_ms = _time_ms(lambda: conv3x3.conv3x3_dgrad_plain(gy, w, cots, affs))
    gn = _channels_last(gy)
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    c_ms = _time_ms(lambda: torch.nn.grad.conv2d_input(
        (B, Cx, H, W), wn, gn, padding=1))
    extra = (B * H * Cg * W if cot else 0) + (B * H * Cx * W if aff else 0)
    bound = _bound_ms(2 * B * H * W * Cg * Cx * 9,
                      2 * (B * H * (Cg + Cx) * W + 9 * Cg * Cx + extra),
                      PEAK_BF16)
    again = call()
    if not torch.equal(out[0] if aff else out, again[0] if aff else again):
        fail(f"dgrad repeat differs at {key}")
    return err, k_ms, p_ms, c_ms, bound, call


def conv_wgrad_case(torch, conv3x3, key, H, rn, vecs, fail):
    """One wgrad shape (B, Ci, Co, W, ingest, cot) of a step, as
    conv_fwd_case: dw within F32_SUM_TOL of the plain version and finite,
    the times and the bound; also returns its max|a - b| / max|b|."""
    B, Ci, Co, W, ingest, cot = key
    x = rn(B, H, Ci, W).bfloat16()
    gy = rn(B, H, Co, W).bfloat16()
    sc, bi = vecs(Ci) if ingest else (None, None)
    cots = None
    if cot:
        cots = (rn(B, H, Co, W).bfloat16(), rn(Co, scale=0.1),
                rn(Co, scale=0.05))
    dw = conv3x3.conv3x3_wgrad(x, gy, sc, bi, cots)
    torch.cuda.synchronize()
    ref = conv3x3.conv3x3_wgrad_plain(x, gy, sc, bi, cots)
    rel = _rel(dw, ref)
    err = (dw - ref).abs().max().item()
    if not (rel <= F32_SUM_TOL and bool(dw.isfinite().all())):
        fail(f"wgrad disagrees at {key}: rel err {rel}")
    call = lambda: conv3x3.conv3x3_wgrad(x, gy, sc, bi, cots)  # noqa: E731
    k_ms = _time_ms(call)
    p_ms = _time_ms(lambda: conv3x3.conv3x3_wgrad_plain(x, gy, sc, bi, cots))
    xn, gn = _channels_last(x), _channels_last(gy)
    c_ms = _time_ms(lambda: torch.nn.grad.conv2d_weight(
        xn, (Co, Ci, 3, 3), gn, padding=1))
    bound = _bound_ms(
        2 * B * H * W * Ci * Co * 9,
        2 * B * H * (Ci + Co * (2 if cot else 1)) * W + 4 * 9 * Ci * Co,
        PEAK_BF16)
    return err, k_ms, p_ms, c_ms, bound, call, rel


def meta_block_checks(torch, meta, taps, metas, tag, limits=None):
    """The fused Meta-Kernel block's kernels (rows 3-5) on every launch of a
    recorded step (``metas``: record_train_step's), on the inputs it had
    there: each against its plain version (F32_SUM_TOL, the bf16 gate),
    twice with bit-equal outputs, kernel 7 and meta_stats forming one tap
    product, a zeroed dA planted in the backward's output rejected by its
    gates, times and bounds. ``limits``: name -> the most the kernel may
    take, summed over the step, in its f32-FFMA bounds (None: printed, not
    gated). Returns {name: KernelTotals}."""
    from rangedet_tpu_torch import _build
    from rangedet_tpu_torch.tools.profile_meta import meta_work, tc_bound_ms

    def fail(msg):
        raise SystemExit(f"[{tag}] {msg}")

    totals = {k: KernelTotals() for k in ("meta_stats", "meta_agg",
                                          "meta_block_bwd")}
    # every launch of the step, on the inputs it had there, each run twice
    # (bit-equal)
    def bwd_check(out, ref):
        ok, err = _bf16_ok(out[0], ref[0])
        rels = [_rel(a, b) for a, b in zip(out[1:], ref[1:])]
        ok &= max(rels) <= F32_SUM_TOL
        ok &= all(bool(a.isfinite().all()) for a in out[1:])
        return ok, err, rels

    fault_rejected = None
    for kind, calls in metas.items():
        for args in calls:
            feat, _, w0 = args[:3]
            B, Hm, C, W = feat.shape
            Cm = w0.shape[1]
            if kind == "stats":
                out = meta.meta_stats(*args)
                torch.cuda.synchronize()
                ref = meta.meta_stats_plain(*args)
                rels = [_rel(a, b) for a, b in zip(out, ref)]
                ok = max(rels) <= F32_SUM_TOL
                err = max((a - b).abs().max().item() for a, b in zip(out, ref))
                name, work, Co = "meta_stats", "stats", 0
                detail = f"sum a, sum a^2 max|a-b|/max|b| {rels[0]:.3g}, " \
                         f"{rels[1]:.3g}"
                one_tap_product(torch, meta, taps, args, fail, tag)
            elif kind == "agg":
                Co = args[8].shape[1]
                out = meta.meta_agg(*args)
                torch.cuda.synchronize()
                ref = meta.meta_agg_plain(*args, out_dtype=torch.float32)
                ok, err = _bf16_ok(out, ref)
                name, work = "meta_agg", "agg"
                detail = f"y max abs err {err:.4g} (max|ref| " \
                         f"{ref.abs().max().item():.4g})"
            else:
                mode = args[7]
                Co = args[6][2].shape[1] if mode == "agg" else 0
                out = meta.meta_bwd(*args)
                torch.cuda.synchronize()
                ref = meta.meta_bwd_plain(*args, out_dtype=torch.float32)
                ok, err, rels = bwd_check(out, ref)
                name, work = "meta_block_bwd", f"bwd_{mode}"
                detail = (f"mode {mode}: dfeat max abs err {err:.4g}; f32 "
                          f"outputs max|a-b|/max|b| " + " ".join(
                              f"{r:.3g}" for r in rels))
                if mode == "agg":  # the planted fault: dA contracted to 0
                    bad = list(out)
                    bad[1] = torch.zeros_like(out[1])
                    fault_rejected = not bwd_check(bad, ref)[0]
            if not ok:
                fail(f"{name} disagrees with its plain version: {detail}")
            again = getattr(meta, f"meta_{kind}")(*args)
            outs = out if isinstance(out, tuple) else (out,)
            agains = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(a, b) for a, b in zip(outs, agains)):
                fail(f"{name} ({work}): a repeat gave other bits")
            k_ms = _time_ms(lambda: getattr(meta, f"meta_{kind}")(*args))
            plain = getattr(meta, f"meta_{kind}_plain")
            p_ms = _time_ms(lambda: plain(*args), iters=3, warmup=1)
            flops, nbytes = meta_work(work, B, Hm, W, C, Cm, Co)
            f32 = _bound_ms(flops, nbytes, PEAK_F32)[0]
            tc = tc_bound_ms(work, B, Hm, W, C, Cm, Co)
            totals[name].add(1, k_ms, p_ms, tc, None, err)
            totals[name].f32_bound_ms += f32
            print(f"[{tag}] {name} (B={B} H={Hm} C={C} W={W} Cm={Cm} Co={Co}): "
                  f"{detail}; repeat bit-equal; kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {tc[0]:.4f} ms tensor cores "
                  f"({tc[1]}), {f32:.4f} ms f32 FFMA ({flops / 1e9:.2f} "
                  f"GFLOP)")
    if fault_rejected is not True:
        fail("the gates of the block backward pass a zeroed dA contraction"
             if fault_rejected is False else "no agg-mode backward launch")
    print(f"[{tag}] meta_block_bwd: the planted fault (dA contracted to "
          f"zero) is rejected by its gates")
    C = metas["stats"][0][0].shape[2]
    for name, kernel in (
            ("meta_block_bwd", f"meta_bwd_kernelILb1ELi{C}E"),
            ("meta_agg", f"meta_fwd_kernelILi1ELi{C}E"),
            ("meta_stats", f"meta_fwd_kernelILi0ELi{C}E")):
        t = totals[name]
        limit = (limits or {}).get(name)
        print(f"[{tag}] {name} over the step: kernel {t.ms:.3f} ms = "
              f"{t.ms / t.f32_bound_ms:.2f}x its f32-FFMA bound "
              f"{t.f32_bound_ms:.3f} ms (limit "
              f"{'none: correctness gates only' if limit is None else limit}"
              f"), {t.ms / t.bound_ms:.1f}x its tensor-core bound "
              f"{t.bound_ms:.3f} ms; kernel (ptxas) "
              f"{ptxas_report(_build.build_log, kernel)}")
        if limit is not None and not t.ms <= limit * t.f32_bound_ms:
            fail(f"{name} summed over the step takes "
                 f"{t.ms / t.f32_bound_ms:.2f}x its f32 bound, more than "
                 f"{limit}x")
    return totals


def phase5(torch, conv3x3, iou_mod, layers, meta, taps, recorded, H, dev,
           tag="5", speed_gates=True):
    """Every kernel call of a recorded train step (``record_train_step``)
    against its plain version on the card: phase [5] at B=2, phase [12](a)
    at B=1 (``tag``). Without ``speed_gates`` the kernels' times against
    cuDNN and their bounds are printed, not gated; the correctness gates
    hold either way. Returns {kernel: KernelTotals}."""
    from rangedet_tpu_torch import _build
    from rangedet_tpu_torch.tools.profile_wgrad import (
        device_ms as wgrad_device_ms,
    )

    fwd, dgrad, wgrad, deconv, iou, metas = recorded
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=g)

    def vecs(C):
        return 1.0 + 0.3 * rn(C), 0.2 * rn(C)

    def fail(msg):
        raise SystemExit(f"[{tag}] {msg}")

    totals = {k: KernelTotals() for k in ("fwd", "dgrad", "wgrad", "iou",
                                          "meta_stats", "meta_agg",
                                          "meta_block_bwd")}
    fwd_split, dgrad_split = {}, {}
    print(f"[{tag}] one B={next(iter(fwd))[0]} train step: {len(fwd)} "
          f"forward, {len(dgrad)} dgrad, {len(wgrad)} wgrad shapes, "
          f"{len(deconv)} deconvs, {len(iou)} IoU-target levels")
    print(f"[{tag}] kernel  B    Ci    Co     W s ingest stats   n  max_abs_err"
          "  kernel_ms   plain_ms  cudnn_ms   bound_ms")
    for key, n in sorted(fwd.items()):
        B, Ci, Co, W, s, ingest, stats = key
        err, k_ms, p_ms, c_ms, bound, call = conv_fwd_case(
            torch, conv3x3, key, H, rn, vecs, fail)
        totals["fwd"].add(n, k_ms, p_ms, bound, c_ms, err)
        print(f"[{tag}] fwd   {B:2d} {Ci:5d} {Co:5d} {W:5d} {s} {int(ingest):6d} "
              f"{int(stats):5d} {n:3d} {err:12.6g} {k_ms:10.4f} {p_ms:10.4f} "
              f"{c_ms:9.4f} {bound[0]:10.4f}")
        print(f"[{tag}]   " + conv_device(
            call, 2 * B * H * (W // s) * Co * Ci * 9, fwd_split, n))

    print(f"[{tag}] kernel  B   Cgy   Cdx     W   cot affine   n  max_abs_err"
          "  kernel_ms   plain_ms  cudnn_ms   bound_ms")
    for key, n in sorted(dgrad.items()):
        B, Cg, Cx, W, cot, aff = key
        err, k_ms, p_ms, c_ms, bound, call = conv_dgrad_case(
            torch, conv3x3, key, H, rn, vecs, fail)
        totals["dgrad"].add(n, k_ms, p_ms, bound, c_ms, err)
        print(f"[{tag}] dgrad {B:2d} {Cg:5d} {Cx:5d} {W:5d} {int(cot):5d} "
              f"{int(aff):6d} {n:3d} {err:12.6g} {k_ms:10.4f} {p_ms:10.4f} "
              f"{c_ms:9.4f} {bound[0]:10.4f}")
        print(f"[{tag}]   " + conv_device(
            call, 2 * B * H * W * Cg * Cx * 9, dgrad_split, n))
    conv_gate(tag, "conv3x3 forward over the step", totals["fwd"], fwd_split,
              FWD_CUDNN_MAX if speed_gates else None)
    conv_gate(tag, "dgrad over the step", totals["dgrad"], dgrad_split,
              DGRAD_CUDNN_MAX if speed_gates else None)

    print(f"[{tag}] kernel  B    Ci    Co     W ingest cot   n  max_abs_err"
          "  max_rel_err  kernel_ms   plain_ms  cudnn_ms   bound_ms"
          "  TFLOP/s of_bound")
    prologue_ms = device_ms = 0.0
    measured = 0  # launches whose device time the profiler read
    for key, n in sorted(wgrad.items()):
        B, Ci, Co, W, ingest, cot = key
        err, k_ms, p_ms, c_ms, bound, call, rel = conv_wgrad_case(
            torch, conv3x3, key, H, rn, vecs, fail)
        dev_ms = wgrad_device_ms(call)
        flops = 2 * B * H * W * Ci * Co * 9
        totals["wgrad"].add(n, k_ms, p_ms, bound, c_ms, err)
        print(f"[{tag}] wgrad {B:2d} {Ci:5d} {Co:5d} {W:5d} {int(ingest):6d} "
              f"{int(cot):3d} {n:3d} {err:12.6g} {rel:12.6g} {k_ms:10.4f} "
              f"{p_ms:10.4f} {c_ms:9.4f} {bound[0]:10.4f} "
              f"{flops / k_ms / 1e9:8.1f} {bound[0] / k_ms:8.1%}")
        if dev_ms is None:
            print(f"[{tag}]   device time per call: not measured (the profiler "
                  "saw none of its kernels)")
            continue
        pro_ms, gemm_ms = dev_ms
        prologue_ms += n * pro_ms
        device_ms += n * (pro_ms + gemm_ms)
        measured += n
        print(f"[{tag}]   device time per call: prologue {pro_ms:.4f} ms, GEMM "
              f"+ reduction {gemm_ms:.4f} ms "
              f"({flops / gemm_ms / 1e9:.1f} TFLOP/s)")
    t = totals["wgrad"]
    regs = ptxas_report(_build.build_log, "conv3x3_wgrad_kernel")
    print(f"[{tag}] wgrad over the step: kernel {t.ms:.3f} ms / cuDNN "
          f"{t.library_ms:.3f} ms = {t.ms / t.library_ms:.2f}x (limit "
          f"{WGRAD_CUDNN_MAX if speed_gates else 'none, printed only'}); "
          f"bound {t.bound_ms:.3f} ms = "
          f"{t.bound_ms / t.ms:.1%} of the kernel's time; device time "
          f"(profiler) over {measured} of the {t.n} launches "
          f"{device_ms:.3f} ms, of which the prologue {prologue_ms:.3f} ms "
          f"= {prologue_ms / max(device_ms, 1e-9):.1%}; GEMM kernel "
          f"(ptxas) {regs}")
    if speed_gates and not t.ms <= WGRAD_CUDNN_MAX * t.library_ms:
        fail(f"wgrad summed over the step takes {t.ms / t.library_ms:.2f}x "
             f"cuDNN's conv2d_weight, more than {WGRAD_CUDNN_MAX}x")

    # the stride-2 and the deconv backward, through the autograd Function
    def grads_both(fn, inputs):
        out = []
        for plain in (False, True):
            leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
            with _plain_convs(conv3x3, plain):
                fn(*leaves).backward()
            out.append([t.grad for t in leaves])
        return [_rel(a, b) for a, b in zip(*out)]

    s2 = sorted(k for k in fwd if k[4] == 2)
    for (B, Ci, Co, W, _, _, _) in sorted(set(s2[:1] + s2[-1:])):
        x = rn(B, H, Ci, W).bfloat16()
        w = (rn(3, 3, Ci, Co) / (3.0 * Ci ** 0.5)).bfloat16()
        sc, bi = vecs(Ci)
        r = rn(B, H, Co, W // 2)
        r1, r2 = rn(Co, scale=1e-3), rn(Co, scale=1e-5)

        def f(x, w, sc, bi):
            y, s1, s2 = conv3x3.conv3x3(x, w, sc, bi, 2, True)
            return ((y.float() * r).sum() + (s1 * r1).sum()
                    + (s2 * r2).sum())

        rels = grads_both(f, (x, w, sc, bi))
        print(f"[{tag}] stride-2 backward (B={B} Ci={Ci} Co={Co} W={W}, ingest "
              f"+ stats): max|a-b|/max|b| dx {rels[0]:.3g} dw {rels[1]:.3g} "
              f"dscale {rels[2]:.3g} dbias {rels[3]:.3g}")
        if not max(rels) <= FN_TOL:
            fail(f"stride-2 backward kernel vs plain {max(rels)} > {FN_TOL}")
    for (B, Ci, Co, W, s) in sorted(deconv):
        x = rn(B, H, Ci, W).bfloat16()
        wt = (rn(Ci, Co, 3, 2 * s) / (3.0 * Ci ** 0.5)).bfloat16()
        r = rn(B, H, Co, W * s)
        rels = grads_both(
            lambda x, wt: (layers.deconv_bhcw(x, wt, s).float() * r).sum(),
            (x, wt))
        print(f"[{tag}] deconv backward (B={B} Ci={Ci} Co={Co} W={W} s={s}): "
              f"max|a-b|/max|b| dx {rels[0]:.3g} dw {rels[1]:.3g}")
        if not max(rels) <= FN_TOL:
            fail(f"deconv backward kernel vs plain {max(rels)} > {FN_TOL}")

    phase5_iou(torch, iou_mod, iou, totals["iou"], tag, speed_gates)
    if any(metas.values()):  # none where the block is not fused ([13])
        totals.update(meta_block_checks(torch, meta, taps, metas, tag, {
            "meta_block_bwd": META_BWD_BOUND_MAX,
            "meta_agg": META_AGG_BOUND_MAX,
            "meta_stats": META_STATS_BOUND_MAX} if speed_gates else None))
    for name, t in totals.items():
        lib = (f"cuDNN {t.library_ms:.3f} ms" if name in ("fwd", "dgrad",
                                                          "wgrad")
               else "no library call")
        print(f"[{tag}] {name}: {t.n} launches per step, kernel {t.ms:.3f} ms, "
              f"plain {t.plain_ms:.3f} ms, bound {t.bound_ms:.3f} ms "
              f"({t.bound_by()}), {lib}")
    return totals


# ---------------------------------------------------------------- phase 6
def phase6(torch, m, cfg, dev):
    conv3x3, iou_mod, meta = m["conv3x3"], m["iou"], m["meta"]

    def fail(msg):
        raise SystemExit(f"[6] {msg}")

    init = m["RangeDet"](**cfg.model_kwargs())
    init.init_from(torch.Generator().manual_seed(SEED))
    init_sd = copy.deepcopy(init.state_dict())
    conv_weights = {n for n, p in init.named_parameters()
                    if p.dim() == 4 and p.shape[2] == 3}
    batch = m["batch_to_device"](
        m["make_batch"](cfg, 2, seed=SEED, num_boxes=20), dev)

    # two planted faults the gates must reject
    real_d, real_w = conv3x3.conv3x3_dgrad, conv3x3.conv3x3_wgrad

    def zeroed_dgrad(*args):
        out = real_d(*args)
        return (tuple(torch.zeros_like(t) for t in out)
                if isinstance(out, tuple) else torch.zeros_like(out))

    faults = {"zeroed-dgrad": dict(conv3x3_dgrad=zeroed_dgrad),
              "flipped-wgrad": dict(conv3x3_wgrad=lambda *a: -real_w(*a))}

    def grads(dtype, plain, fault=None, fused=cfg.use_pallas_meta):
        model = m["RangeDet"](**dict(cfg.model_kwargs(), dtype=dtype,
                                     use_pallas_meta=fused))
        model.load_state_dict(init_sd)
        model = model.to(dev).train()
        iou_fn = (iou_mod.iou_target_plain if plain
                  else iou_mod.iou_target)
        planted = (mock.patch.multiple(conv3x3, **faults[fault]) if fault
                   else contextlib.nullcontext())
        with _plain_convs(conv3x3, plain, meta), planted, \
                mock.patch.object(iou_mod, "iou_target", iou_fn):
            targets = m["build_train_targets"](batch, cfg)
            cls, reg = model(batch["input_data"], batch["coord"])
            total, metrics = m["compute_losses"](cls, reg, targets, cfg)
            total.backward()
        return ({k: float(v.detach()) for k, v in metrics.items()},
                {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()})

    runs = {"kernel-bf16": grads(torch.bfloat16, False),
            "plain-bf16": grads(torch.bfloat16, True),
            "plain-f32": grads(torch.float32, True),
            # the same step with the materialized Meta-Kernel block
            "materialized-bf16": grads(torch.bfloat16, False, fused=False)}
    runs.update({f: grads(torch.bfloat16, False, f) for f in faults})
    stat = {}
    for a, b in (("kernel-bf16", "plain-bf16"), ("kernel-bf16", "plain-f32"),
                 ("plain-bf16", "plain-f32"),
                 ("kernel-bf16", "materialized-bf16"),
                 *((f, "plain-bf16") for f in faults)):
        (ma, ga), (mb, gb) = runs[a], runs[b]
        rels = sorted((_rel(ga[n], gb[n]), n) for n in ga)
        vals = [r for r, _ in rels]
        head = max(r for r, n in rels if "_lvl_" in n and (
            "cls_logit" in n or "reg_delta" in n))
        conv = statistics.median(r for r, n in rels if n in conv_weights)
        va = torch.cat([ga[n].flatten().double() for n in ga])
        vb = torch.cat([gb[n].flatten().double() for n in ga])
        cos = float(va @ vb / (va.norm() * vb.norm()))
        loss_rel = max(abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30)
                       for k in ma)
        stat[a, b] = dict(median=statistics.median(vals), conv=conv,
                          head=head, loss=loss_rel)
        print(f"[6] {a} vs {b}: per-parameter gradient max|a-b|/max|b| over "
              f"{len(vals)} tensors: median {statistics.median(vals):.4g}, "
              f"p90 {vals[int(0.9 * (len(vals) - 1))]:.4g}, max "
              f"{rels[-1][0]:.4g} ({rels[-1][1]}); median over the "
              f"{len(conv_weights)} 3x3 conv weights {conv:.4g}; head "
              f"projections max {head:.4g}; cosine of the whole gradients "
              f"{cos:.6f}; losses max rel diff {loss_rel:.4g}, total_loss "
              f"{ma['total_loss']:.6f} vs {mb['total_loss']:.6f}")

    def passes(s):
        return (s["loss"] <= LOSS_TOL and s["head"] <= HEAD_GRAD_TOL
                and s["median"] <= MEDIAN_TOL
                and s["conv"] <= CONV_MEDIAN_TOL)

    for a in ("kernel-bf16", *faults):
        s = stat[a, "plain-bf16"]
        print(f"[6] gates, {a} vs plain-bf16: losses {s['loss']:.4g} <= "
              f"{LOSS_TOL}; head projections {s['head']:.4g} <= "
              f"{HEAD_GRAD_TOL}; median {s['median']:.4g} <= {MEDIAN_TOL}; "
              f"conv-weight median {s['conv']:.4g} <= {CONV_MEDIAN_TOL}: "
              f"{'pass' if passes(s) else 'reject'}")
    if not passes(stat["kernel-bf16", "plain-bf16"]):
        fail("kernel path vs plain path outside the gates above")
    for f in faults:
        if passes(stat[f, "plain-bf16"]):
            fail(f"the gates pass the planted fault {f}")
    fused_vs_mat = stat["kernel-bf16", "materialized-bf16"]["loss"]
    print(f"[6] step 1, fused Meta-Kernel block vs materialized: losses max "
          f"rel diff {fused_vs_mat:.4g} <= {LOSS_TOL}")
    if not fused_vs_mat <= LOSS_TOL:
        fail("the fused block's step-1 losses differ from the materialized "
             "block's")

    model = m["RangeDet"](**cfg.model_kwargs())
    model.load_state_dict(init_sd)
    model = model.to(dev)
    state = m["create_train_state"](model, cfg, STEPS_PER_EPOCH, seed=None)
    step = m["make_train_step"](state, cfg)
    expected = train_launches(cfg, "6")
    losses, launches = [], None
    for i in range(5):
        torch.cuda.synchronize()
        reset_counts(m)
        metrics = step(batch)
        torch.cuda.synchronize()
        launches = read_counts(m)
        if launches != expected:
            fail(f"step {i}: launches {launches}, expected {expected}")
        losses.append(float(metrics["total_loss"]))
    print(f"[6] 5 steps, launches per step {launches}; total_loss "
          + " ".join(f"{v:.6f}" for v in losses))
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"loss not finite or not falling: {losses}")

    snap = (copy.deepcopy(model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()), state.step)
    m1 = step(batch)
    model.load_state_dict(snap[0])
    state.optimizer.load_state_dict(snap[1])
    state.step = snap[2]
    m2 = step(batch)
    same = all(torch.equal(m1[k], m2[k]) for k in m1)
    print(f"[6] two steps from one state: total_loss "
          f"{float(m1['total_loss'])!r} and {float(m2['total_loss'])!r}; all "
          f"metrics bit-equal: {same}")
    if not same:
        fail("a repeated step from one state gave other losses")

    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_ms(lambda: step(batch))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[6] B=2 train step median {step_ms:.2f} ms over 10 steps; peak "
          f"memory {peak:.2f} GiB")
    return launches, step_ms


def check_taps(torch, taps, args, tag, limit=None, one_ulp=False):
    """Kernel 7 on the arguments of one launch of an eval forward: within
    the bf16 gate of the f32 plain version (with ``one_ulp``, within one
    bf16 ulp of it), within JAX's bound of the bf16 plain version or the
    nearer of the two to f32, a bit-equal repeat; timed and bounded.
    ``limit``: the most it may take in its f32-FFMA bounds (None: printed,
    not gated). Returns its KernelTotals."""
    from rangedet_tpu_torch import _build
    from rangedet_tpu_torch.tools.profile_meta import (
        meta_work,
        tc_bound_ms,
        ulps,
    )

    def fail(msg):
        raise SystemExit(f"[{tag}] {msg}")

    feat, cb, w0 = args[:3]
    B, H, C, W = feat.shape
    Cm = w0.shape[1]
    y = taps.meta_kernel_taps(*args)
    torch.cuda.synchronize()
    # f32 from the same bf16 operands (the coordinates and the MLP
    # rounded to bf16 as the kernel's wrapper rounds them): the kernel
    # rounds once, at the product
    ref = taps.meta_kernel_taps_plain(*(a.to(feat.dtype).float() for a in args))
    ok, err = _bf16_ok(y, ref)
    ref_max = ref.abs().max().item()
    if not ok:
        fail(f"B={B}: kernel vs f32 plain max abs err {err} (max|ref| "
             f"{ref_max})")
    ulp = ""
    if one_ulp:
        d = ulps(y, ref.to(feat.dtype))
        n_off, d_max = int((d > 0).sum()), int(d.max())
        del d
        ulp = (f"{n_off} elements one bf16 ulp from the f32 plain version "
               f"rounded (at most {d_max}); ")
        if d_max > 1:
            fail(f"B={B}: kernel 7 {d_max} bf16 ulp from the f32 plain "
                 f"version")
    if not torch.equal(y, taps.meta_kernel_taps(*args)):
        fail(f"B={B}: a repeat of the taps kernel gave other bits")
    xla = taps.meta_kernel_taps_plain(*args).float()
    y = y.float()
    d = (y - xla).abs()
    outside = d > TAPS_TOL * (1.0 + xla.abs())
    nearer = (y - ref).abs() <= (xla - ref).abs()
    n_out, n_bad = int(outside.sum()), int((outside & ~nearer).sum())
    d_max = d.max().item()
    del y, ref, xla, d, outside, nearer
    if n_bad:
        fail(f"B={B}: {n_bad} elements outside JAX's bound of the bf16 "
             f"form where the kernel is not the nearer to f32")
    k_ms = _time_ms(lambda: taps.meta_kernel_taps(*args))
    p_ms = _time_ms(lambda: taps.meta_kernel_taps_plain(*args), iters=3,
                    warmup=1)
    flops, nbytes = meta_work("taps", B, H, W, C, Cm, 0)
    bound = _bound_ms(flops, nbytes, PEAK_F32)
    tc = tc_bound_ms("taps", B, H, W, C, Cm, 0)
    t = KernelTotals()
    t.add(1, k_ms, p_ms, tc, None, err)
    t.f32_bound_ms = bound[0]
    print(f"[{tag}] meta_kernel_taps B={B} (H={H} C={C} W={W} Cm={Cm}): max "
          f"abs err {err:.4g} vs the f32 plain version (bf16 gate; "
          f"max|ref| {ref_max:.4g}); {ulp}"
          f"{d_max:.4g} vs the bf16 plain version (the XLA form), "
          f"{n_out} of {B * H * 9 * C * W} elements outside JAX's bound "
          f"{TAPS_TOL}, each nearer the f32 reference; repeat "
          f"bit-equal; kernel {k_ms:.4f} ms = {k_ms / bound[0]:.2f}x its "
          f"f32 bound {bound[0]:.4f} ms ({bound[1]}; {flops / 1e9:.2f} "
          f"GFLOP f32, {nbytes / 1e6:.1f} MB; limit "
          f"{'none: correctness gates only' if limit is None else limit}"
          f"), {k_ms / tc[0]:.1f}x its "
          f"tensor-core bound {tc[0]:.4f} ms ({tc[1]}); kernel (ptxas) "
          f"{ptxas_report(_build.build_log, f'meta_fwd_kernelILi2ELi{C}E')}; "
          f"plain {p_ms:.4f} ms")
    if limit is not None and not k_ms <= limit * bound[0]:
        fail(f"B={B}: the taps kernel takes {k_ms / bound[0]:.2f}x its "
             f"f32 bound, more than {limit}x")
    return t


# ---------------------------------------------------------------- phase 7
def phase7(torch, m, cfg, dev):
    """Kernel 7 against its plain version on the inputs of a B=4 and a B=1
    eval forward, its gradient, and the eval step with and without it.
    Returns {B: KernelTotals} of the kernel."""
    taps = m["taps"]

    def fail(msg):
        raise SystemExit(f"[7] {msg}")

    model = m["RangeDet"](**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    materialized = m["RangeDet"](**dict(cfg.model_kwargs(),
                                        use_pallas_meta=False))
    materialized.load_state_dict(model.state_dict())
    models = {True: model.to(dev).eval(), False: materialized.to(dev).eval()}
    steps = {k: m["make_eval_step"](v, cfg) for k, v in models.items()}
    totals = {}
    for B in (4, 1):
        inputs = m["build_eval_inputs"](
            m["make_batch"](cfg, B, seed=SEED, num_boxes=20), cfg, dev)
        seen, real = [], taps.meta_kernel_taps

        def keep(*args):
            seen.append(tuple(a.detach().clone() for a in args))
            return real(*args)

        with mock.patch.object(taps, "meta_kernel_taps", keep), \
                torch.inference_mode():
            model(inputs["input_data"], inputs["coord"])
        if len(seen) != meta_units(cfg):
            fail(f"B={B}: {len(seen)} taps calls in the forward")
        totals[B] = check_taps(torch, taps, seen[0], "7",
                               META_TAPS_BOUND_MAX)

        with torch.inference_mode():
            outs = {k: v(inputs["input_data"], inputs["coord"])
                    for k, v in models.items()}
        rels = [_rel(a, b) for a, b in zip(outs[True][0] + outs[True][1],
                                           outs[False][0] + outs[False][1])]
        del outs
        if not max(rels) <= MODEL_TOL:
            fail(f"B={B}: eval outputs with and without the taps kernel "
                 f"differ by {max(rels):.4g} > {MODEL_TOL}")
        times, peaks = {True: [], False: []}, {}
        for use in (True, False, False, True):  # in turns
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times[use].append(_median_ms(lambda: steps[use](inputs)))
            peaks[use] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[7] B={B} eval step with the taps kernel vs the plain taps: "
              f"outputs max|a-b|/max|b| {max(rels):.4g} (bound "
              f"{MODEL_TOL}); median ms "
              + ", ".join(f"{t:.2f}" for t in times[True]) + " vs "
              + ", ".join(f"{t:.2f}" for t in times[False])
              + f"; peak memory {peaks[True]:.2f} vs {peaks[False]:.2f} GiB")
    del models, steps

    # MetaKernelTaps' gradient: the plain version's autograd VJP
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = [torch.randn(1, 4, 64, 40, device=dev, generator=g).relu().bfloat16(),
         torch.randn(1, 4, 3, 40, device=dev, generator=g).bfloat16()]
    x += [0.3 * torch.randn(*s, device=dev, generator=g)
          for s in ((3, 32), (32,), (32, 64), (64,))]
    r = torch.randn(1, 4, 9 * 64, 40, device=dev, generator=g)
    grads = []
    for fn in (taps.MetaKernelTaps.apply, taps.meta_kernel_taps_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in x]
        (fn(*leaves).float() * r).sum().backward()
        grads.append([t.grad for t in leaves])
    rels = [_rel(a, b) for a, b in zip(*grads)]
    print("[7] MetaKernelTaps gradient vs the plain version's autograd, "
          "max|a-b|/max|b| (feat, coords, w0, b0, w1, b1): "
          + " ".join(f"{v:.3g}" for v in rels))
    if not max(rels) <= FN_TOL:
        fail(f"MetaKernelTaps gradient {max(rels)} > {FN_TOL}")
    return totals


def phase7_files(torch, m, cfg, dev, per_step):
    """Training and serving as users drive them, from dataset files: write
    a training and a validation split, train an epoch from the files,
    resume to a second one with validation, test at its epoch, score,
    restore, eval_checkpoint. ``per_step``: phase 6's launches of one train
    step, by kernel."""
    import threading

    import numpy as np

    train_cli = m["train_cli"]

    def fail(msg):
        raise SystemExit(f"[7] {msg}")

    n_meta = meta_units(cfg)
    n_fwd = conv_launches(cfg)[0]
    # one validation frame is a B=1 eval forward: the forward kernel and
    # the Meta-Kernel taps
    per_frame = dict.fromkeys(per_step, 0)
    per_frame.update(fwd=n_fwd, meta_kernel_taps=n_meta)
    threads0 = threading.active_count()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
        H, W = cfg.feat_size
        m["write_waymo_files"](data, FILE_FRAMES, H=H, W=W, seed=SEED,
                               image_set="training", num_boxes=20,
                               class_choices=(1, 2))
        recs = m["write_waymo_files"](data, VAL_FRAMES, H=H, W=W,
                                      seed=SEED + 1, image_set="validation",
                                      num_boxes=20, class_choices=(1, 2))
        print(f"[7] wrote {FILE_FRAMES} training and {VAL_FRAMES} validation "
              f"frames of {H}x{W} as .npz files and a roidb each (holes, a "
              f"no-label-zone strip, vehicles and pedestrians)")

        def train(*extra):
            """tools.train from the files -> (history, state, validations,
            stdout, launches outside and inside the validations, number
            of validations)."""
            inside = []
            real = train_cli.build_validation

            def counted_validation(*a, **kw):
                run = real(*a, **kw)

                def counted():
                    torch.cuda.synchronize()
                    before = read_counts(m)
                    out = run()
                    torch.cuda.synchronize()
                    inside.append({k: v - before[k]
                                   for k, v in read_counts(m).items()})
                    return out
                return counted

            out = io.StringIO()
            torch.cuda.synchronize()
            reset_counts(m)
            with mock.patch.object(train_cli, "build_validation",
                                   counted_validation), \
                    contextlib.redirect_stdout(out):
                hist, state, val = train_cli.main([
                    "--config", RECIPE, "--data-root", data,
                    "--sampling-rate", "1", "--batch", "2",
                    "--steps-per-epoch", "2", "--num-workers", "2",
                    "--experiment-dir", exp, "--device", dev.type, *extra])
            torch.cuda.synchronize()
            total = read_counts(m)
            for line in out.getvalue().splitlines():
                print(f"[7]   {line}")
            ev = {k: sum(d[k] for d in inside) for k in total}
            return (hist, state, val, out.getvalue(),
                    {k: v - ev[k] for k, v in total.items()}, ev,
                    len(inside))

        def gate_steps(tag, hist, tr):
            want = {k: 2 * v for k, v in per_step.items()}
            if len(hist) != 2 or not all(math.isfinite(h["total_loss"])
                                         for h in hist):
                fail(f"{tag}: bad losses {hist}")
            if tr != want:
                fail(f"{tag}: launches in its 2 steps {tr}, expected {want}")

        hist0, _, val, _, tr, _, n_val = train("--epochs", "1")
        gate_steps("tools.train --epochs 1", hist0, tr)
        ecfg = cfg.replace(experiment_dir=exp)
        if m["latest_epoch"](ecfg) != 0 or n_val or val:
            fail(f"tools.train --epochs 1 left checkpoint epoch "
                 f"{m['latest_epoch'](ecfg)}, {n_val} validations")

        hist1, state, val, text, tr, ev, n_val = train(
            "--epochs", "2", "--resume", "--eval-every", "1",
            "--eval-frames", str(VAL_FRAMES))
        gate_steps("tools.train --resume", hist1, tr)
        if "resumed from epoch 0" not in text or state.step != 4:
            fail(f"tools.train --resume: no resume marker, or step count "
                 f"{state.step} != 4")
        ckpts = [e for e in (0, 1) if os.path.exists(
            m["checkpoint_path"](ecfg, e))]
        if ckpts != [0, 1] or m["latest_epoch"](ecfg) != 1:
            fail(f"checkpoints of epochs {ckpts} after the resume")
        bufs = [s["momentum_buffer"] for s in state.optimizer.state.values()]
        if not bufs or not all(b.device.type == dev.type for b in bufs):
            fail("momentum buffers off the card after the resume")
        want = {k: VAL_FRAMES * v for k, v in per_frame.items()}
        vals = [v for mt in val.get(1, {}).values() for v in mt.values()]
        if (list(val) != [1] or f"epoch 1 validation: {val[1]}" not in text
                or not vals or not all(math.isfinite(v) for v in vals)):
            fail(f"validation: {val}")
        if n_val != 1 or ev != want:
            fail(f"{n_val} validations launched {ev}, expected {want}")
        hist = hist0 + hist1
        print(f"[7] tools.train from the files: epoch 0 (2 steps, checkpoint "
              f"0), then --resume: resumed from epoch 0 at step "
              f"{hist1[0]['step']}, epoch 1 (2 steps, checkpoint 1, "
              f"{len(bufs)} momentum buffers on the card), validation on "
              f"{VAL_FRAMES} frames {json.dumps(val[1])}; launches per 2 "
              f"steps as phase 6's per step, the validation's "
              f"{VAL_FRAMES} x ({n_fwd} conv3x3 forward, {n_meta} taps), "
              f"no taps launch in training; total_loss "
              + " ".join(f"{h['total_loss']:.5f}" for h in hist))
        print("[7] tools.train per step at 64x2650, B=2, 2 loader workers "
              "(epoch 0, then the resumed epoch 1): loader wait ms "
              + " ".join(f"{h['data_ms']:.2f}" for h in hist)
              + "; step ms " + " ".join(f"{h['step_ms']:.2f}" for h in hist))

        reset_counts(m)
        path = m["test_cli"].main([
            "--config", RECIPE, "--data-root", data, "--image-set",
            "validation", "--batch", str(FILE_BATCH), "--experiment-dir",
            exp, "--epoch", "1", "--device", dev.type, "--output",
            os.path.join(tmp, "pred.pkl")])
        torch.cuda.synchronize()
        n_steps = -(-VAL_FRAMES // FILE_BATCH)
        got = read_counts(m)
        want = (n_steps * n_fwd, n_steps * n_meta)
        if (got["fwd"], got["meta_kernel_taps"]) != want:
            fail(f"tools.test: {got['fwd']} conv3x3 and "
                 f"{got['meta_kernel_taps']} taps launches, expected {want}")
        with open(path, "rb") as f:
            anno, outputs = pickle.load(f), pickle.load(f)
        if sorted(outputs) != sorted(r["rec_id"] for r in recs) or \
                sorted(anno) != sorted(outputs):
            fail(f"the pickle holds {sorted(outputs)}")
        n_det = 0
        for rec in outputs.values():
            det = rec["det_xyzlwhyaws"]["veh"]
            if det.ndim != 2 or det.shape[1] != 8 or \
                    not np.isfinite(det).all():
                fail("malformed detections")
            n_det += len(det)
        records = m["evaluate_pred"].main(["--config", RECIPE, "--pred",
                                           path, "--buckets"])
        veh = [r for r in records if r["class"] == "veh"]
        if len(veh) != 1 or veh[0]["frames"] != VAL_FRAMES:
            fail(f"evaluate_pred: {records}")
        print(f"[7] tools.test from the validation files at epoch 1: "
              f"{len(outputs)} frames in {n_steps} step(s) of "
              f"B={FILE_BATCH} ({want[0]} conv3x3 and {want[1]} taps "
              f"launches), {n_det} detections; tools.evaluate_pred: "
              f"{json.dumps(veh[0])}")

        rcfg = m["load_config"](RECIPE, is_train=False).replace(
            experiment_dir=exp)
        restored = m["RangeDet"](**rcfg.model_kwargs()).to(dev)
        _, rep = m["restore_checkpoint"](restored, rcfg, 1)
        stacked = [m["record_to_inputs"](r, rcfg.pad_field, rcfg.max_gt_boxes)
                   for r in recs]
        inputs = m["build_eval_inputs"](
            {k: np.stack([b[k] for b in stacked]) for k in stacked[0]},
            rcfg, dev)
        a, b = (m["make_eval_step"](x.eval(), rcfg)(inputs)
                for x in (state.model, restored))
        same = all(torch.equal(a[c][k], b[c][k]) for c in a for k in a[c])
        print(f"[7] checkpoint epoch {rep} restored: eval outputs on one "
              f"B={VAL_FRAMES} batch bit-equal to the trained model's: "
              f"{same}")
        if not same:
            fail("the restored model's eval outputs differ")
        del restored, state

        lines = m["eval_checkpoint"].main([
            "--config", RECIPE, "--experiment-dir", exp, "--data-root", data,
            "--n-frames", str(VAL_FRAMES), "--min-scores", "0.5,0.1",
            "--device", dev.type])
        vals = [v for line in lines for mt in line["metrics"].values()
                for v in mt.values()]
        if len(lines) != 2 or not all(math.isfinite(v) for v in vals):
            fail(f"eval_checkpoint: {lines}")
        print(f"[7] tools.eval_checkpoint: {len(lines)} lines, all finite")
    if threading.active_count() != threads0:
        fail(f"{threading.active_count()} threads after the file path, "
             f"{threads0} before it")
    print(f"[7] the file path in {time.perf_counter() - t_phase:.1f} s; "
          f"{threads0} threads before it and after it")


# ---------------------------------------------------------------- phase 8
def phase8_iou(torch, m, cfg, iou):
    """Row 6 on the multiclass step's calls: each within IOU_TOL of the plain
    version on its own view, a bit-equal repeat, the same bits as on a
    contiguous copy of the view; timed. Returns its KernelTotals."""
    iou_mod, K = m["iou"], cfg.num_classes

    def fail(msg):
        raise SystemExit(f"[8] {msg}")

    t = KernelTotals()
    for i, call in enumerate(iou):
        d, p, gt, topk = call
        lvl, k = divmod(i, K)
        name = cfg.class_names[k]
        # class k's 8 channels of the level's (B, H, Ws, 8K) deltas, in place
        if d.is_contiguous() or (k and not d.storage_offset()):
            fail(f"level {lvl} {name}: deltas {tuple(d.shape)} strides "
                 f"{d.stride()} offset {d.storage_offset()} are no view of "
                 f"the head's {8 * K} channels")
        r = iou_call(torch, iou_mod, call, iters=1, warmup=1, reps=3)
        dense = torch.equal(r["out"], iou_mod.iou_target(d.contiguous(), p,
                                                         gt, topk))
        if not (r["err"] <= IOU_TOL and r["finite"]):
            fail(f"IoU target disagrees at level {lvl} {name}: max err "
                 f"{r['err']}")
        if not (r["same"] and dense):
            fail(f"IoU target at level {lvl} {name}: repeat bit-equal "
                 f"{r['same']}, equal to the contiguous copy's {dense}")
        add_iou(t, r)
        print(f"[8] IoU target level {lvl} class {name}: deltas "
              f"{tuple(d.shape)} strides {d.stride()} offset "
              f"{d.storage_offset()}, {int((gt.abs().sum((2, 3)) > 0).sum())} "
              f"GT rows of the class, nv sum {int(r['nv'].sum())}, "
              f"{r['pairs']} pairs ({r['live_pairs']} live); max abs err "
              f"{r['err']:.3g} (limit {IOU_TOL}), blocks off the plain "
              f"prep's (nv, corners, area bits) {r['off']}, repeat "
              f"bit-equal, equal to the contiguous copy's; kernels "
              f"{r['ms']:.4f} ms (prep {r['prep_ms']:.4f}, clip "
              f"{r['clip_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    x = t.extra
    print(f"[8] IoU target over the multiclass step ({t.n} calls): kernels "
          f"{t.ms:.4f} ms = prep {x['prep_ms']:.4f} + clip "
          f"{x['clip_ms']:.4f} ms; the clip at "
          f"{x['clip_ms'] / x['clip_bound_ms']:.2f}x its bound "
          f"{x['clip_bound_ms']:.4f} ms over the contract's padded pairs, "
          f"{x['clip_ms'] / x['clip_live_bound_ms']:.2f}x over live pairs; "
          f"plain {t.plain_ms:.2f} ms")
    return t


def eval_checks(torch, m, dev, recipe, tag, taps_check=False,
                wnms_rows=False):
    """A recipe's eval step at B=4 and B=1: launches, per-class finite boxes
    and valid counts, the post-processing's one weighted-NMS call over
    every class's rows, each class's outputs bit-equal to the class run
    alone (``class_alone``), kernel path against the plain path, median
    ms, the WNMS share, peak memory. With ``taps_check``, kernel 7
    on the inputs the step gave it (check_taps, within one bf16 ulp of the
    f32 plain version, no speed gate); with ``wnms_rows`` (on a card), the
    WNMS kernel on the B=4 step's own rows and keep caps against the plain
    version (wnms_check). Returns {B: its KernelTotals, "wnms": wnms_check's
    and "wnms_launches": the B=4 step's WNMS launches} and the taps
    launches of the B=1 step."""
    nms, taps = m["nms"], m["taps"]
    cfg = m["load_config"](recipe, is_train=False)

    def fail(msg):
        raise SystemExit(f"[{tag}] {msg}")

    model = m["RangeDet"](**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    eval_step = m["make_eval_step"](model, cfg)
    n_fwd, n_taps = conv_launches(cfg)[0], meta_units(cfg)
    # held to each class run alone: all of it on the card; validity and
    # truncation in a CPU rehearsal (class_alone)
    alone_keys = (("boxes",) if dev.type == "cuda" else ()) + (
        "valid", "truncated")
    totals = {}
    for B in (4, 1):
        inputs = m["build_eval_inputs"](
            m["make_batch"](cfg, B, seed=SEED, num_boxes=20,
                            style="vehicles"), cfg, dev)
        seen, real_taps = [], taps.meta_kernel_taps

        def keep(*args):
            seen.append(tuple(a.detach().clone() for a in args))
            return real_taps(*args)

        torch.cuda.synchronize()
        reset_counts(m)
        with mock.patch.object(taps, "meta_kernel_taps", keep):
            out = eval_step(inputs)
        torch.cuda.synchronize()
        got = read_counts(m)
        if (got["fwd"], got["meta_kernel_taps"]) != (n_fwd, n_taps):
            fail(f"B={B}: {got['fwd']} conv3x3 and {got['meta_kernel_taps']}"
                 f" taps launches, expected {n_fwd} and {n_taps}")
        if sorted(out) != sorted(cfg.class_names):
            fail(f"B={B}: classes {sorted(out)}")
        counts = {}
        for name in cfg.class_names:
            boxes, valid = out[name]["boxes"], out[name]["valid"]
            if (tuple(boxes.shape) != (B, cfg.post_nms_top_n[name], 8)
                    or not torch.isfinite(boxes[valid]).all()):
                fail(f"B={B}: non-finite or misshapen {name} boxes")
            counts[name] = valid.sum(1).tolist()
        if taps_check:
            totals[B] = check_taps(torch, taps, seen[0], tag, one_ulp=True)
        del seen

        with torch.inference_mode():
            got = model(inputs["input_data"], inputs["coord"])
            with mock.patch.object(m["conv3x3"], "conv3x3_bhcw",
                                   m["conv3x3"].conv3x3_bhcw_plain), \
                    mock.patch.object(m["taps"], "meta_kernel_taps",
                                      m["taps"].meta_kernel_taps_plain):
                want = model(inputs["input_data"], inputs["coord"])
        rels = [_rel(a, b) for a, b in zip(got[0] + got[1],
                                           want[0] + want[1])]
        if not all(torch.isfinite(a).all() for a in got[0] + got[1]):
            fail(f"B={B}: non-finite logits/deltas")
        if not max(rels) <= MODEL_TOL:
            fail(f"B={B}: kernel path vs plain path {max(rels):.4g} > "
                 f"{MODEL_TOL}")

        calls, real_wnms = [], nms.weighted_nms

        def grab(*a, **kw):
            calls.append((a, kw))
            return real_wnms(*a, **kw)

        n0 = nms.LAUNCHES
        with mock.patch.object(nms, "weighted_nms", grab), \
                torch.inference_mode():
            m["run_inference"](*got, inputs, cfg)
        if len(calls) != 1 or calls[0][0][0].shape[0] != B * len(
                cfg.class_names):
            fail(f"B={B}: {len(calls)} WNMS calls, expected one over "
                 f"B x {len(cfg.class_names)} rows")
        if wnms_rows and B == 4 and dev.type == "cuda":
            totals["wnms_launches"] = nms.LAUNCHES - n0
            with torch.inference_mode():
                totals["wnms"] = wnms_check(torch, nms, *calls[0], tag=tag)
        with torch.inference_mode():
            folded = m["run_inference"](*got, inputs, cfg)
            for k, name in enumerate(cfg.class_names):
                alone = class_alone(m["run_inference"], got, inputs, cfg, k)
                if not all(torch.equal(folded[name][key], alone[key])
                           for key in alone_keys):
                    fail(f"B={B}: {name}'s outputs differ from the class "
                         f"run alone")
        torch.cuda.reset_peak_memory_stats()
        step_ms = _median_ms(lambda: eval_step(inputs))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with torch.inference_mode():
            wnms = [_median_ms(lambda: real_wnms(*a, **kw))
                    for a, kw in calls]
        cands = [int(a[2].sum()) for a, _ in calls]
        print(f"[{tag}] B={B} {recipe} eval step: {n_fwd} conv3x3 and "
              f"{n_taps} taps launches; kernel vs plain path max|a-b|/max|b| per "
              f"output " + " ".join(f"{r:.4g}" for r in rels)
              + f" (bound {MODEL_TOL}); valid boxes per frame "
              + ", ".join(f"{c} {counts[c]}" for c in cfg.class_names)
              + f"; valid candidates {cands}; median {step_ms:.2f} ms, WNMS "
              + " + ".join(f"{w:.2f}" for w in wnms)
              + f" = {sum(wnms):.2f} ms = {100 * sum(wnms) / step_ms:.1f}%; "
              f"peak memory {peak:.2f} GiB")
    del model, eval_step
    return totals, n_taps


def class_alone(run_inference, fwd, inputs, cfg, k):
    """Class k's outputs of ``run_inference`` with its logits and deltas
    alone, a one-class post-processing. On the card they equal the
    class's outputs of the whole bit for bit; on the CPU (a rehearsal)
    torch's sigmoid rounds a class's strided logits in its scalar path,
    the whole's contiguous ones in its vector path, so scores may differ
    in the last bit and near-tied candidates swap ranks: there validity
    and truncation are held alone."""
    cls, reg = fwd
    name = cfg.class_names[k]
    one = cfg.replace(class_names=(name,), label_set=(cfg.label_set[k],))
    return run_inference([c[..., k:k + 1] for c in cls],
                         [d[..., 8 * k:8 * k + 8] for d in reg], inputs,
                         one)[name]


def phase8_files(torch, m, dev):
    """The multiclass recipe from files with its augmentation on: tools.train
    (every mapped training frame through apply_augmentations with both
    names), validation with three classes, tools.test, evaluate_pred and
    the prediction export."""
    import threading

    import numpy as np

    augment, waymo, train_cli = m["augment"], m["waymo"], m["train_cli"]
    cfg = m["load_config"](MULTICLASS, is_train=False)

    def fail(msg):
        raise SystemExit(f"[8] {msg}")

    threads0 = threading.active_count()
    mapped, augmented = [], []
    real_map, real_aug = waymo.record_to_inputs, augment.apply_augmentations

    def counted_map(rec, *a, augment=(), **kw):
        if augment:
            mapped.append(tuple(augment))
        return real_map(rec, *a, augment=augment, **kw)

    def counted_aug(frame, rng, names):
        augmented.append(tuple(names))
        return real_aug(frame, rng, names)

    with tempfile.TemporaryDirectory() as tmp:
        data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
        H, W = cfg.feat_size
        m["write_waymo_files"](data, FILE_FRAMES, H=H, W=W, seed=SEED + 8,
                               image_set="training", num_boxes=20,
                               class_choices=(1, 2, 4))
        recs = m["write_waymo_files"](data, VAL_FRAMES, H=H, W=W,
                                      seed=SEED + 9, image_set="validation",
                                      num_boxes=20, class_choices=(1, 2, 4))
        val_classes = sorted({int(c) for r in recs for c in r["gt_class"]})
        out = io.StringIO()
        with mock.patch.object(waymo, "record_to_inputs", counted_map), \
                mock.patch.object(augment, "apply_augmentations",
                                  counted_aug), \
                contextlib.redirect_stdout(out):
            hist, _, val = train_cli.main([
                "--config", MULTICLASS, "--data-root", data,
                "--sampling-rate", "1", "--batch", "2", "--epochs", "1",
                "--steps-per-epoch", "2", "--num-workers", "2",
                "--eval-every", "1", "--eval-frames", str(VAL_FRAMES),
                "--experiment-dir", exp, "--device", dev.type])
        for line in out.getvalue().splitlines():
            print(f"[8]   {line}")
        want = tuple(cfg.augment)
        if (len(mapped) < 4 or set(mapped) != {want}
                or augmented != [want] * len(mapped)):
            fail(f"{len(mapped)} training frames mapped with augment "
                 f"{set(mapped)}, apply_augmentations called "
                 f"{len(augmented)} times with {set(augmented)}")
        if len(hist) != 2 or not all(math.isfinite(h["total_loss"])
                                     for h in hist):
            fail(f"bad losses {hist}")
        ecfg = cfg.replace(experiment_dir=exp)
        if m["latest_epoch"](ecfg) != 0:
            fail(f"checkpoint epoch {m['latest_epoch'](ecfg)}, expected 0")
        res = val.get(0, {})
        vals = [v for mt in res.values() for v in mt.values()]
        if (sorted(res) != sorted(cfg.class_names) or not vals
                or not all(math.isfinite(v) for v in vals)):
            fail(f"validation: {val}")
        if threading.active_count() != threads0:
            fail(f"{threading.active_count()} threads after tools.train, "
                 f"{threads0} before it")
        print(f"[8] tools.train --config {MULTICLASS} from {FILE_FRAMES} "
              f"training frames of classes (1, 2, 4): {len(mapped)} frames "
              f"mapped, each through apply_augmentations {want}; total_loss "
              + " ".join(f"{h['total_loss']:.5f}" for h in hist)
              + f"; checkpoint 0; validation on {VAL_FRAMES} frames (GT "
              f"classes {val_classes}) {json.dumps(res)}; {threads0} threads "
              f"before and after")

        pred = os.path.join(tmp, "pred.pkl")
        m["test_cli"].main([
            "--config", MULTICLASS, "--data-root", data, "--image-set",
            "validation", "--batch", str(FILE_BATCH), "--experiment-dir",
            exp, "--epoch", "0", "--device", dev.type, "--output", pred])
        with open(pred, "rb") as f:
            anno, outputs = pickle.load(f), pickle.load(f)
        if sorted(outputs) != sorted(r["rec_id"] for r in recs) or \
                sorted(anno) != sorted(outputs):
            fail(f"the pickle holds {sorted(outputs)}")
        n_det = dict.fromkeys(cfg.class_names, 0)
        for rec in outputs.values():
            det = rec["det_xyzlwhyaws"]
            if sorted(det) != sorted(cfg.class_names):
                fail(f"the pickle's classes {sorted(det)}")
            for c, d in det.items():
                if d.ndim != 2 or d.shape[1] != 8 or \
                        not np.isfinite(d).all():
                    fail(f"malformed {c} detections")
                n_det[c] += len(d)
        records = m["evaluate_pred"].main(["--config", MULTICLASS, "--pred",
                                           pred])
        if ([r["class"] for r in records] != list(cfg.class_names)
                or any(r["frames"] != VAL_FRAMES
                       or r["iou"] != cfg.eval_iou_thresh[r["class"]]
                       for r in records)):
            fail(f"evaluate_pred: {records}")
        exported = os.path.join(tmp, "pred.json")
        with contextlib.redirect_stdout(io.StringIO()):
            n_rows = m["bin_cli"].main(["--pred", pred, "--out", exported])
        with open(exported) as f:
            rows = json.load(f)
        by_type = {}
        for r in rows:
            by_type[r["type"]] = by_type.get(r["type"], 0) + 1
        want_types = {t: n_det[c] for c, t in
                      zip(cfg.class_names, cfg.label_set) if n_det[c]}
        if (n_rows != len(rows) or by_type != want_types
                or not (by_type.get(2) and by_type.get(4))):
            fail(f"the export's rows by type {by_type}, the pickle's "
                 f"detections {n_det}")
        print(f"[8] tools.test at epoch 0: {len(outputs)} frames, "
              f"detections {n_det}; tools.evaluate_pred: "
              + "; ".join(json.dumps(r) for r in records)
              + f"; tools.create_prediction_bin_3d: {n_rows} rows by Waymo "
              f"type {by_type}")


def phase8(torch, m, dev):
    """The multiclass recipe at full width and depth: one recorded B=2
    train step (launches, row 6's calls gated and timed on their views),
    5 falling losses, the median step and peak memory; the eval step; the
    file path with the recipe's augmentation. Returns (row 6's
    KernelTotals, launches per step)."""
    t_phase = time.perf_counter()

    def fail(msg):
        raise SystemExit(f"[8] {msg}")

    cfg = m["load_config"](MULTICLASS, is_train=True).replace(
        base_lr=0.01, warmup_epochs=0)
    model = m["RangeDet"](**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    state = m["create_train_state"](model.to(dev), cfg, STEPS_PER_EPOCH,
                                    seed=None)
    step = m["make_train_step"](state, cfg)
    host = m["make_batch"](cfg, 2, seed=SEED, num_boxes=20, style="vehicles")
    classes = sorted({int(c) for c in host["gt_class"][host["gt_valid"] > 0]})
    if classes != sorted(cfg.label_set):
        fail(f"the batch's GT classes {classes}")
    batch = m["batch_to_device"](host, dev)
    expected = train_launches(cfg, "8")
    torch.cuda.synchronize()
    reset_counts(m)
    recorded = record_train_step(step, batch, m["conv3x3"], m["iou"],
                                 m["layers"], m["meta"])
    torch.cuda.synchronize()
    launches = read_counts(m)
    iou = recorded[4]
    del recorded
    if launches != expected or len(iou) != expected["iou"]:
        fail(f"launches {launches} ({len(iou)} IoU calls), expected "
             f"{expected}")
    print(f"[8] {MULTICLASS}, B=2 train step at {cfg.pad_field[0]}x"
          f"{cfg.pad_field[1]} (GT classes {classes}): launches {launches}")
    totals = phase8_iou(torch, m, cfg, iou)
    del iou

    losses = []
    for i in range(5):
        torch.cuda.synchronize()
        reset_counts(m)
        metrics = step(batch)
        torch.cuda.synchronize()
        if read_counts(m) != expected:
            fail(f"step {i}: launches {read_counts(m)}")
        losses.append(float(metrics["total_loss"]))
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"loss not finite or not falling: {losses}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_ms(lambda: step(batch))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[8] 5 steps, total_loss " + " ".join(f"{v:.6f}" for v in losses)
          + f"; B=2 train step median {step_ms:.2f} ms over 10 steps; peak "
          f"memory {peak:.2f} GiB")
    del model, state, step, batch

    serve, _ = eval_checks(torch, m, dev, MULTICLASS, "8", wnms_rows=True)
    phase8_files(torch, m, dev)
    print(f"[8] phase 8 in {time.perf_counter() - t_phase:.1f} s")
    return totals, launches, serve


# ---------------------------------------------------------------- phase 9
def phase9(torch, m, dev, earlier):
    """The wide-channel recipe at full width and depth: one recorded B=2
    train step (launches as the config implies), the Meta-Kernel block's
    kernels at C=128 on its launches (meta_block_checks: no speed gate),
    each conv shape of the step that ``earlier`` (phase 5's recorded
    forward, dgrad and wgrad shapes) lacks once as forward, dgrad and
    wgrad under phase 5's gates, 5 falling losses, the median of 10 steps
    and the peak memory; then the eval step at B=4 and B=1 with kernel 7
    at 9C = 1152 channels held on its inputs (eval_checks). Returns (rows
    3-5's KernelTotals, the step's launches, row 7's {B: KernelTotals},
    its launches per B=1 eval step)."""
    t_phase = time.perf_counter()

    def fail(msg):
        raise SystemExit(f"[9] {msg}")

    cfg = m["load_config"](TPUOPT, is_train=True).replace(
        base_lr=0.01, warmup_epochs=0)
    H = cfg.pad_field[0]
    model = m["RangeDet"](**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    state = m["create_train_state"](model.to(dev), cfg, STEPS_PER_EPOCH,
                                    seed=None)
    step = m["make_train_step"](state, cfg)
    batch = m["batch_to_device"](
        m["make_batch"](cfg, 2, seed=SEED, num_boxes=20), dev)
    expected = train_launches(cfg, "9")
    torch.cuda.synchronize()
    reset_counts(m)
    fwd, dgrad, wgrad, _, _, metas = record_train_step(
        step, batch, m["conv3x3"], m["iou"], m["layers"], m["meta"])
    torch.cuda.synchronize()
    launches = read_counts(m)
    if launches != expected:
        fail(f"launches {launches}, expected {expected}")
    widths = {tuple(a[0].shape[2:3]) + (a[2].shape[1],) for a in
              metas["stats"]}
    print(f"[9] {TPUOPT}, B=2 train step at {cfg.pad_field[0]}x"
          f"{cfg.pad_field[1]}: launches {launches}; Meta-Kernel (C, Cm) "
          f"{sorted(widths)}")
    if widths != {(128, 32)}:
        fail(f"the step's Meta-Kernel widths {widths}, expected C=128, Cm=32")
    totals = meta_block_checks(torch, m["meta"], m["taps"], metas, "9")
    del metas

    g = torch.Generator(device=dev).manual_seed(SEED + 9)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=g)

    def vecs(C):
        return 1.0 + 0.3 * rn(C), 0.2 * rn(C)

    conv3x3 = m["conv3x3"]
    print("[9] conv shapes of the step that phase 5 did not run, once each "
          "(kernel   B    Ci    Co     W ...  max_abs_err  kernel_ms   "
          "plain_ms  cudnn_ms   bound_ms)")
    n_new = 0
    for name, shapes, case in (("fwd", fwd, conv_fwd_case),
                               ("dgrad", dgrad, conv_dgrad_case),
                               ("wgrad", wgrad, conv_wgrad_case)):
        new = sorted(k for k in shapes if k not in earlier[name])
        n_new += len(new)
        t = KernelTotals()  # the new shapes' launches in the step
        for key in new:
            err, k_ms, p_ms, c_ms, bound, _, *_ = case(
                torch, conv3x3, key, H, rn, vecs, fail)
            t.add(shapes[key], k_ms, p_ms, bound, c_ms, err)
            print(f"[9] {name:5s} {' '.join(f'{v:5d}' for v in key)} "
                  f"{err:12.6g} {k_ms:10.4f} {p_ms:10.4f} {c_ms:9.4f} "
                  f"{bound[0]:10.4f}")
        print(f"[9] {name} over the {t.n} launches of the step at these "
              f"shapes: kernel {t.ms:.3f} ms, cuDNN {t.library_ms:.3f} ms "
              f"({t.ms / max(t.library_ms, 1e-9):.2f}x), bound "
              f"{t.bound_ms:.3f} ms")
    wide = [k for d in (fwd, dgrad, wgrad) for k in d if 256 in k[1:3]]
    print(f"[9] {n_new} new conv shapes held (forward, dgrad and wgrad; "
          f"{len(wide)} shapes of the step have Ci or Co of 256)")
    if not wide:
        fail("no conv shape of 256 channels in the step")

    losses = []
    for i in range(5):
        torch.cuda.synchronize()
        reset_counts(m)
        metrics = step(batch)
        torch.cuda.synchronize()
        if read_counts(m) != expected:
            fail(f"step {i}: launches {read_counts(m)}")
        losses.append(float(metrics["total_loss"]))
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"loss not finite or not falling: {losses}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = _median_ms(lambda: step(batch))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[9] 5 steps, total_loss " + " ".join(f"{v:.6f}" for v in losses)
          + f"; B=2 train step median {step_ms:.2f} ms over 10 steps; peak "
          f"memory {peak:.2f} GiB")
    del model, state, step, batch

    taps_totals, taps_launches = eval_checks(torch, m, dev, TPUOPT, "9",
                                             taps_check=True)
    print(f"[9] phase 9 in {time.perf_counter() - t_phase:.1f} s")
    return totals, launches, taps_totals, taps_launches


# ---------------------------------------------------------------- phase 10
def remat_launches(cfg, per_step):
    """The launches of one step with ``remat``: the step's, plus each
    backbone stage's convs (all but the 4 deconvs and the head's) and the
    fused block's meta_stats and meta_agg again, as the backward recomputes
    the stages' forward."""
    n_levels = len(cfg.fpn_strides)
    stage = (conv_launches(cfg)[0] - 4
             - n_levels * (cfg.cls_conv_layers + cfg.reg_conv_layers))
    n_meta = meta_units(cfg) if cfg.use_pallas_meta else 0
    out = dict(per_step)
    out.update(fwd=per_step["fwd"] + stage,
               meta_stats=per_step["meta_stats"] + n_meta,
               meta_agg=per_step["meta_agg"] + n_meta)
    return out, stage


def remat_pair(torch, m, cfg, dev, remat_kw, tag, fail):
    """One step from one seeded init and one batch without and with
    ``remat_kw``: losses, parameters and running statistics bit-equal, the
    launches of each; then the median of 10 more steps and the peak
    memory of each. Returns (launches without, launches with)."""
    init = m["RangeDet"](**cfg.model_kwargs())
    init.init_from(torch.Generator().manual_seed(SEED))
    init_sd = copy.deepcopy(init.state_dict())
    batch = m["batch_to_device"](
        m["make_batch"](cfg, 2, seed=SEED, num_boxes=20), dev)
    runs = {}
    for name, c in (("plain", cfg), ("remat", cfg.replace(**remat_kw))):
        model = m["RangeDet"](**c.model_kwargs())
        model.load_state_dict(init_sd)
        model = model.to(dev)
        state = m["create_train_state"](model, c, STEPS_PER_EPOCH, seed=None)
        step = m["make_train_step"](state, c)
        torch.cuda.synchronize()
        reset_counts(m)
        metrics = step(batch)
        torch.cuda.synchronize()
        launches = read_counts(m)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        ms = _median_ms(lambda: step(batch))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[name] = (metrics, sd, launches, ms, peak)
        del model, state, step
    (ma, sa, la, msa, pa), (mb, sb, lb, msb, pb) = runs["plain"], \
        runs["remat"]
    losses = all(torch.equal(ma[k], mb[k]) for k in ma)
    stats = [k for k in sa if "running" in k]
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    print(f"[10] {tag}: step 1 without and with {remat_kw}: total_loss "
          f"{float(ma['total_loss'])!r} / {float(mb['total_loss'])!r}, all "
          f"losses bit-equal {losses}; {len(sa) - len(stats)} parameters and "
          f"{len(stats)} running statistics, {len(differ)} differ "
          f"{differ[:4]}; launches {la} / {lb}; B=2 step median {msa:.2f} "
          f"/ {msb:.2f} ms over 10 steps ({msb / msa - 1:+.1%}), peak "
          f"memory {pa:.2f} / {pb:.2f} GiB ({pb / pa - 1:+.1%})")
    if not losses or differ:
        fail(f"{tag}: the step with {remat_kw} differs from the plain one")
    return la, lb


def standardization_check(torch, model):
    """-> step(...) wrapper state: after each step, on the card with no
    wait, the largest |mean| and |std - 1| over the output filters of the
    kernels AdamWS standardizes, and the smallest such largest deviation
    of the other conv and Linear weights."""
    from rangedet_tpu_torch.train.schedule import standardized_params

    std = standardized_params(model)
    ids = {id(p) for p, _ in std}
    others = [(p, (1, 2, 3) if p.dim() == 4 else (1,))
              for p in model.parameters()
              if p.dim() in (2, 4) and id(p) not in ids]

    def dev(p, dims):
        w = p.detach().double()
        mean = w.mean(dim=dims)
        sd = (w - w.mean(dim=dims, keepdim=True)).square().mean(
            dim=dims).sqrt()
        return torch.maximum(mean.abs().max(), (sd - 1).abs().max())

    def read():
        return torch.stack([
            torch.stack([dev(p, dims) for p, dims in std]).max(),
            torch.stack([dev(p, d) for p, d in others]).min()])

    return read, len(std), len(others)


def optimizer_update_ms(torch, m, cfg, ocfg, dev):
    """Median ms of one optimizer update (train_step.apply_update: the
    clip, the optimizer, AdamWS's standardization) on the recipe's
    parameters with seeded gradients, for ``cfg``'s optimizer and
    ``ocfg``'s."""
    model = m["RangeDet"](**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, device=dev, generator=g)
    out = []
    for c in (cfg, ocfg):
        state = m["create_train_state"](model, c, STEPS_PER_EPOCH, seed=None)
        out.append(_median_ms(lambda: m["train_step"].apply_update(state,
                                                                  c)))
    return out


def steady_ms(hist):
    """data_ms and step_ms medians and the mean wall a step of a train
    CLI history's steps after the first of each epoch (``steps``)."""
    steady = [h for i, h in enumerate(hist)
              if i and h["epoch"] == hist[i - 1]["epoch"]]
    return dict(
        data_ms=statistics.median(x["data_ms"] for x in steady),
        step_ms=statistics.median(x["step_ms"] for x in steady),
        wall_ms=statistics.mean(x["data_ms"] + x["step_ms"] for x in steady),
        n=len(steady), steps=steady)


def phase10(torch, m, cfg, dev, per_step):
    """remat and the train CLI's options on the recipe at full size: (a)
    ``remat`` with the fused block and (b) ``remat_meta`` with the
    materialized one, each step bit-equal to the plain step from one init
    and batch (losses, parameters, running statistics), launches as the
    recompute implies, median ms and peak memory of both; (c) tools.train
    from files with adamws, onecycle, the global-norm clip, remat and
    log_frequency LOG_FREQ, --tensorboard --profile-steps 2 over 2 epochs
    (finite losses, launches, the speedometer lines of log.txt, the trace
    and its conv kernels, every AdamWS kernel standardized after each step
    and no other weight, LR and momentum as the schedules give them), then
    --resume (the Adam state restored bit-equal, on the card); (d) the
    data_ms / step_ms a step from the second step of an epoch of the
    resumed run and of one of the recipe as it ships, the device's busy
    share over the traced window, and one optimizer update's ms of both.
    Returns ``steady_ms`` of the recipe's epoch from the files."""
    import glob

    from rangedet_tpu_torch.train import checkpoint as ckpt_mod
    from rangedet_tpu_torch.train.schedule import (
        build_momentum_schedule,
        build_schedule,
    )

    t_phase = time.perf_counter()

    def fail(msg):
        raise SystemExit(f"[10] {msg}")

    want_remat, n_stage = remat_launches(cfg, per_step)
    print(f"[10] expected launches of a remat step: phase 6's + {n_stage} "
          f"conv3x3 forward (the stages' convs, not the 4 deconvs or the "
          f"head's) + one meta_stats and one meta_agg a fused block; dgrad, "
          f"wgrad, the block backward and the IoU target unchanged")
    la, lb = remat_pair(torch, m, cfg, dev, dict(remat=True),
                        "(a) fused block", fail)
    if la != per_step or lb != want_remat:
        fail(f"(a) launches {la} / {lb}, expected {per_step} / "
             f"{want_remat}")
    mcfg = cfg.replace(use_pallas_meta=False)
    la, lb = remat_pair(torch, m, mcfg, dev, dict(remat_meta=True),
                        "(b) materialized block", fail)
    if la != lb or any(la[k] for k in ("meta_stats", "meta_agg",
                                       "meta_block_bwd",
                                       "meta_kernel_taps")):
        fail(f"(b) launches {la} / {lb}: the materialized step runs no "
             f"Meta-Kernel kernel, with or without remat_meta")

    train_cli = m["train_cli"]
    with tempfile.TemporaryDirectory() as tmp:
        data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
        H, W = cfg.feat_size
        m["write_waymo_files"](data, CLI_FRAMES, H=H, W=W, seed=SEED + 2,
                               image_set="training", num_boxes=20)
        recipe = os.path.join(tmp, "options_recipe.py")
        with open(recipe, "w") as f:
            f.write(CLI_RECIPE.format(recipe=RECIPE, freq=LOG_FREQ))
        files = ["--data-root", data, "--sampling-rate", "1", "--batch",
                 "2", "--num-workers", "2", "--device", dev.type]
        argv = ["--config", recipe, "--experiment-dir", exp] + files
        ccfg = train_cli.apply_overrides(
            m["load_config"](recipe, is_train=True),
            train_cli.parse_args(argv + ["--epochs", "2"]))
        spe = CLI_FRAMES // 2
        lr_of, mom_of = build_schedule(ccfg, spe), build_momentum_schedule(
            ccfg, spe)

        # run 1: 2 epochs, every step's standardization read on the card
        reads, counts = [], {}
        real_make = m["make_train_step"]

        def checked_make(state, c, group=None):
            step = real_make(state, c, group)
            read, n_std, n_other = standardization_check(torch, state.model)
            counts.update(std=n_std, other=n_other)

            def checked(batch):
                out = step(batch)
                reads.append(read())
                return out
            return checked

        out = io.StringIO()
        torch.cuda.synchronize()
        reset_counts(m)
        with mock.patch.object(m["train_step"], "make_train_step",
                               checked_make), contextlib.redirect_stdout(out):
            hist, state, _ = train_cli.main(
                argv + ["--epochs", "2", "--tensorboard", "--profile-steps",
                        "2"])
        torch.cuda.synchronize()
        launches = read_counts(m)
        n = len(hist)
        want = {k: n * v for k, v in want_remat.items()}
        if n != 2 * spe or launches != want:
            fail(f"(c) {n} steps, launches {launches}, expected "
                 f"{2 * spe} and {want}")
        if not all(math.isfinite(h["total_loss"]) for h in hist):
            fail(f"(c) losses {[h['total_loss'] for h in hist]}")
        devs = torch.stack(reads).tolist()
        worst_std = max(d[0] for d in devs)
        least_other = min(d[1] for d in devs)
        print(f"[10] (c) tools.train, {ccfg.optimizer}, {ccfg.lr_mode}, "
              f"clip {ccfg.clip_mode}, remat {ccfg.remat}: {n} steps from "
              f"{CLI_FRAMES} files, launches {n} x (a)'s remat step; "
              f"total_loss " + " ".join(f"{h['total_loss']:.4f}"
                                        for h in hist))
        print(f"[10] (c) after each of the {n} steps: the {counts['std']} "
              f"kernels AdamWS standardizes within {worst_std:.3g} of mean 0 "
              f"and std 1 a filter (gate {STD_TOL}); the other "
              f"{counts['other']} conv and Linear weights at least "
              f"{least_other:.3g} off")
        if not (worst_std <= STD_TOL < least_other):
            fail("(c) the AdamWS standardization is off")
        for h in hist:
            if (h["lr"], h["momentum"]) != (lr_of(h["step"]),
                                            mom_of(h["step"])):
                fail(f"(c) step {h['step']}: lr {h['lr']!r}, momentum "
                     f"{h['momentum']!r}, the schedules "
                     f"{lr_of(h['step'])!r}, {mom_of(h['step'])!r}")

        run_dir = os.path.join(exp, ccfg.name)
        with open(os.path.join(run_dir, "log.txt")) as f:
            log = f.read()
        lines = [ln for ln in log.splitlines() if "frames/s lr=" in ln]
        where = [(int(ln.split("Epoch[")[1].split("]")[0]),
                  int(ln.split("Batch[")[1].split("]")[0]),
                  float(ln.split("lr=")[1].split()[0])) for ln in lines]
        want_lines = [(h["epoch"], h["step"] - h["epoch"] * spe,
                       round(h["lr"], 6)) for h in hist[LOG_FREQ - 1::
                                                        LOG_FREQ]]
        print(f"[10] (c) log.txt: {len(lines)} speedometer lines, one each "
              f"{LOG_FREQ} steps, printed lr = the schedule's: "
              f"{where == want_lines}; the last: {lines[-1] if lines else ''}")
        if where != want_lines:
            fail(f"(c) speedometer lines {where}, expected {want_lines}")
        events = glob.glob(os.path.join(run_dir, "tb", "events.*"))
        warned = "tensorboard writer unavailable" in log
        print(f"[10] (c) --tensorboard: {len(events)} event file(s)"
              + ("; tensorboard is not installed: one warning, no events"
                 if warned else ""))
        if not events and not warned:
            fail("(c) no TensorBoard events and no warning")
        traces = glob.glob(os.path.join(run_dir, "traces", "*.json"))
        if len(traces) != 1:
            fail(f"(c) traces {traces}")
        with open(traces[0]) as f:
            trace = json.load(f)["traceEvents"]
        kernels = [e for e in trace if e.get("cat") == "kernel"]
        conv_names = sorted({e["name"].split("<")[0] for e in kernels
                             if "conv3x3" in e["name"]})
        spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in trace
                 if e.get("ph") == "X" and "ts" in e]
        window = max(b for _, b in spans) - min(a for a, _ in spans)
        busy, end = 0.0, -math.inf
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        print(f"[10] (c)/(d) --profile-steps 2: {os.path.basename(traces[0])}"
              f" ({os.path.getsize(traces[0]) / 2 ** 20:.1f} MiB), "
              f"{len(kernels)} kernel events, the port's conv kernels "
              f"{conv_names}; device busy {busy / 1e3:.2f} ms of the traced "
              f"{window / 1e3:.2f} ms ({busy / window:.1%}; steps 10-11 "
              f"under the profiler)")
        if not conv_names:
            fail("(c) the trace names no conv3x3 kernel")
        del trace, kernels, spans

        # run 2: --resume from epoch 1's checkpoint, the Adam state
        restored = {}
        real_restore = ckpt_mod.restore_checkpoint

        def keep_restored(target, c, epoch=None):
            target, ep = real_restore(target, c, epoch)
            restored["opt"] = copy.deepcopy(target.optimizer.state_dict())
            restored["step"] = target.step
            return target, ep

        out2 = io.StringIO()
        with mock.patch.object(ckpt_mod, "restore_checkpoint",
                               keep_restored), \
                contextlib.redirect_stdout(out2):
            hist2, _, _ = train_cli.main(argv + ["--epochs", "3",
                                                 "--resume"])
        saved = state.optimizer.state_dict()["state"]
        got = restored["opt"]["state"]
        same = sorted(got) == sorted(saved) and all(
            torch.equal(got[k][n], saved[k][n]) for k in saved
            for n in saved[k])
        where = {n: sorted({got[k][n].device.type for k in got})
                 for n in ("exp_avg", "exp_avg_sq", "step")}
        print(f"[10] (c) --resume: {'resumed from epoch 1' in out2.getvalue()}"
              f" at step {restored['step']}; the AdamW state of "
              f"{len(got)} parameters bit-equal to run 1's end: {same}; "
              f"on {where}; {len(hist2)} more steps, total_loss "
              + " ".join(f"{h['total_loss']:.4f}" for h in hist2))
        if ("resumed from epoch 1" not in out2.getvalue() or not same
                or restored["step"] != 2 * spe
                or where != {"exp_avg": [dev.type], "exp_avg_sq": [dev.type],
                             "step": ["cpu"]}):
            fail("(c) the resume did not restore the Adam state")
        # run 3: the recipe as it ships (sgd, cosine, no remat), one epoch
        with contextlib.redirect_stdout(io.StringIO()):
            hist3, _, _ = train_cli.main(
                ["--config", RECIPE, "--experiment-dir",
                 os.path.join(tmp, "exp_recipe"), "--epochs", "1"] + files)
        for name, h in (("the recipe as it ships", hist3),
                        ("the options recipe, resumed", hist2)):
            st = steady_ms(h)
            print(f"[10] (d) tools.train steady state, steps 2..{len(h)} of "
                  f"an epoch from the files ({ccfg.pad_field[0]}x"
                  f"{ccfg.pad_field[1]}, B=2, 2 loader workers), {name}: "
                  f"data_ms " + " ".join(f"{x['data_ms']:.2f}"
                                         for x in st["steps"])
                  + "; step_ms " + " ".join(f"{x['step_ms']:.2f}"
                                            for x in st["steps"])
                  + f"; medians {st['data_ms']:.2f} / {st['step_ms']:.2f} ms;"
                  f" mean wall a step (wait + dispatch + the window's sync) "
                  f"{st['wall_ms']:.2f} ms")
        loader = steady_ms(hist3)
    update_ms = optimizer_update_ms(torch, m, cfg, ccfg, dev)
    print(f"[10] (d) one optimizer update of the recipe's parameters "
          f"(median of 10, synchronized): sgd + elementwise clip {update_ms[0]:.2f} ms, "
          f"adamws + global-norm clip + onecycle {update_ms[1]:.2f} ms")
    print(f"[10] phase 10 in {time.perf_counter() - t_phase:.1f} s")
    return loader


# --------------------------------------------------------------- phase 11
# the packed cache's codec (data/device_cache.py): one pc step (i16 at
# 409.5 a meter) and one range step (u16 over 80 m)
PC_BAND = 1 / 409.5
RANGE_BAND = 80.0 / 65535.0
# per regression dim (of 8): the sqrt-signed offsets move by at most
# sqrt(|dp| (1 + |offset| / r)), 3 m offsets at r >= 1 m; cos / sin of the
# yaw - azimuth by the azimuth's dp / r; the rest come from the GT alone
REG_TOL = (0.1, 0.1, 1e-5, 1e-5, 2.5e-3, 2.5e-3, 1e-5, 1e-5)


# the codec's budgets on the normalized channels (tests/test_device_cache.py):
# one quantization step over the channel's sigma; the azimuth 3e-3 rad
CHANNEL_TOL = (2e-3 / math.sqrt(1500.0) + 1e-6,
               (1 / 255.0) / math.sqrt(0.01) / 2 + 1e-6,
               (1 / 255.0) / math.sqrt(0.0267) / 2 + 1e-6,
               2.5e-3 / math.sqrt(307.4), 2.5e-3 / math.sqrt(219.1),
               2.5e-3 / math.sqrt(1.0), 1e-5, 3e-3 / math.sqrt(2.55))
# [11](a): the renderer on the card against it on the CPU on the same
# draws, within RENDER_TOL (relative, with as much absolute), but for the
# pixels whose ray grazes a face or ties with the wall (a flip: a box hit
# on one side only), at most FACE_FLIP_FRAC of them
RENDER_TOL = 1e-5
FACE_FLIP_FRAC = 1e-4
H2D_STEP_MAX = 64 * 1024  # [11](c): host-to-device bytes a cached step
CACHE_FRAMES = 16
CACHE_STEPS = 3
PROBE_STEPS = 20
PROBE_HOLDOUT = 8
AUG_SEED0 = 0  # RandomState(AUG_SEED0 + i): frame i's host draws in [11](b)


def codec_check(host, cached, rotated=False):
    """A batch rebuilt from the packed cache (``cached``) against
    record_to_inputs' (``host``), numpy dicts: masks, NLZ flags and GT
    classes exact, GT boxes within 1e-5, points within 2.5e-3 (4e-3 after
    a rotation), the range within 2e-3 and each normalized channel within
    CHANNEL_TOL (x and y doubled after a rotation, which moves a point's
    error onto both; the azimuth modulo the +-pi cut). -> the largest
    error of each channel. Raises AssertionError on a breach."""
    import numpy as np

    for k in ("mask", "is_in_nlz", "gt_class", "gt_valid"):
        assert np.array_equal(cached[k], host[k]), k
    for k, tol in (("gt_csa", 1e-5), ("pc", 4e-3 if rotated else 2.5e-3),
                   ("unnorm_range", 2e-3)):
        err = float(np.abs(cached[k] - host[k]).max())
        assert err <= tol, (k, err, tol)
    err = np.abs(cached["input_data"] - host["input_data"])
    err[..., 7] = np.minimum(
        err[..., 7], np.abs(err[..., 7] - 2 * np.pi / np.sqrt(2.55)))
    worst = [float(err[..., c].max()) for c in range(err.shape[-1])]
    for c, tol in enumerate(CHANNEL_TOL):
        tol *= 2 if rotated and c in (3, 4) else 1
        assert worst[c] <= tol * 1.05, (c, worst[c], tol)
    return worst


def render_diff(got, want, tol=RENDER_TOL):
    """Two renders of the same draws (numpy dicts of render_scenes) ->
    (face flips: pixels hit on one side only or at another range, dropped
    pixels whose azimuth differs (atan2 of signed zeros, which follow the
    sign of cos(azimuth) at the column where it crosses 0), the keys with
    any other element outside ``tol``)."""
    import numpy as np

    flip = ((got["mask"] != want["mask"])
            | (np.abs(got["unnorm_range"] - want["unnorm_range"])
               > tol * np.abs(want["unnorm_range"]) + tol))[..., 0]
    zero_pt = ((np.abs(want["pc"]).max(-1) == 0)
               & (np.abs(got["pc"]).max(-1) == 0))
    bad = []
    for k in want:
        g, w = got[k], want[k]
        ok = np.abs(g - w) <= tol * np.abs(w) + tol
        if k == "input_data":
            ok[..., 7] |= zero_pt
        if g.ndim == 4:
            ok |= flip[..., None]
        if g.shape != w.shape or not ok.all():
            bad.append(k)
    az = np.abs(got["input_data"][..., 7] - want["input_data"][..., 7])
    return int(flip.sum()), int((zero_pt & (az > tol)).sum()), bad


def trace_in_ranges(trace, names):
    """What a chrome trace's CPU ranges ``names`` launched on the device
    (a runtime call in such a range, its device event by correlation id):
    -> dict of h2d_bytes and h2d (host-to-device copies), memcpy_calls
    (runtime memcpy calls of any direction), matched (those of them whose
    device copy the trace holds), kinds ({direction: copies}), all_h2d
    (every host-to-device copy of the trace), launches and kernel_us (the
    kernels launched, their summed device time)."""
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in trace
              if e.get("cat") == "user_annotation" and e.get("name") in names]

    def corr_of(pred):
        return {e.get("args", {}).get("correlation") for e in trace
                if e.get("cat") == "cuda_runtime" and pred(e.get("name", ""))
                and any(a <= e["ts"] <= b for a, b in ranges)}

    def corr(e):
        return e.get("args", {}).get("correlation")

    copy_corr = corr_of(lambda n: "Memcpy" in n)
    launch_corr = corr_of(lambda n: "LaunchKernel" in n)
    copies = [e for e in trace if e.get("cat") == "gpu_memcpy"]
    mine = [e for e in copies if corr(e) in copy_corr]
    kinds = {}
    for e in mine:
        kind = e.get("name", "").split(" (")[0].replace("Memcpy ", "")
        kinds[kind] = kinds.get(kind, 0) + 1
    h2d = [e for e in mine if "HtoD" in e.get("name", "")]
    kernels = [e for e in trace if e.get("cat") == "kernel"
               and corr(e) in launch_corr]
    return dict(
        h2d_bytes=sum(e["args"].get("bytes", 0) for e in h2d), h2d=len(h2d),
        memcpy_calls=len(copy_corr), matched=len({corr(e) for e in mine}),
        kinds=kinds, all_h2d=sum(1 for e in copies
                                 if "HtoD" in e.get("name", "")),
        launches=len(kernels), kernel_us=sum(e.get("dur", 0)
                                             for e in kernels))


def codec_band(torch, batch, cfg):
    """(B, H, Wp) bool: the pixels whose point lies within PC_BAND of a
    face of a valid GT box (signed distance to the box surface, box frame,
    Chebyshev), or whose range lies within RANGE_BAND of an FPN interval
    bound; -> (band, face pixels, bound pixels). The codec may move such a
    pixel across the assignment's or the interval's decision."""
    n_gt = max(int(batch["gt_valid"].sum(1).max()), 1)  # valid rows lead
    pc, gt = batch["pc"].float(), batch["gt_csa"][:, :n_gt].float()
    B, H, Wp = pc.shape[:3]
    p = pc.reshape(B, -1, 1, 3)
    c, yaw = gt[:, None, :, :3], gt[:, None, :, 6]
    dx, dy, dz = (p - c).unbind(-1)
    cs, sn = torch.cos(yaw), torch.sin(yaw)
    lx, ly = cs * dx + sn * dy, -sn * dx + cs * dy
    sd = torch.maximum(torch.maximum(lx.abs() - gt[:, None, :, 3] / 2,
                                     ly.abs() - gt[:, None, :, 4] / 2),
                       dz.abs() - gt[:, None, :, 5] / 2)
    face = ((sd.abs() <= PC_BAND) & (batch["gt_valid"][:, None, :n_gt] > 0)
            ).any(-1).reshape(B, H, Wp)
    rng = batch["unnorm_range"][..., 0]
    bound = torch.zeros_like(face)
    for lo, hi in cfg.fpn_intervals.values():
        bound |= ((rng - lo).abs() <= RANGE_BAND) | (
            (rng - hi).abs() <= RANGE_BAND)
    bound &= batch["mask"][..., 0] > 0  # a hole's range is 0 on both sides
    return face | bound, int(face.sum()), int(bound.sum())


def cached_targets_check(torch, build_train_targets, cfg, host, cached):
    """build_train_targets on a batch rebuilt from the packed cache
    (``cached``: gathered, unpacked, augmented on the device, finalized)
    against it on the host's batch of the same frames and augmentation
    (``host``), both dicts of tensors on one device. Outside the codec's
    band (``codec_band`` of the host batch) every mask and weight plane is
    equal, the regression targets within REG_TOL, the strided points
    within PC_BAND, and a pixel's 1 / (points in its box) implies counts
    apart by at most the face band's pixels; the GT corners within
    1e-4. -> dict of the counts and largest errors. Raises AssertionError
    on the first breach."""
    from rangedet_tpu_torch.ops.targets import stride_slice

    band, n_face, n_bound = codec_band(torch, host, cfg)
    th = build_train_targets(host, cfg)
    td = build_train_targets(cached, cfg)
    out = dict(band_face_px=n_face, band_bound_px=n_bound, differ_px=0,
               reg_err=[0.0] * 8, pc_err=0.0, corner_err=0.0,
               count_shift=0)
    for s in cfg.fpn_strides:
        keep = ~stride_slice(band, s, w_axis=2)  # (B, H, Ws)
        a_h = th[f"reg_weight_s{s}"].sum(-1) > 0
        a_d = td[f"reg_weight_s{s}"].sum(-1) > 0
        differ = (a_h != a_d) | (th[f"mask_s{s}"][..., 0]
                                 != td[f"mask_s{s}"][..., 0])
        assert not (differ & keep).any(), (
            f"stride {s}: {int((differ & keep).sum())} pixels outside the "
            f"codec band differ in assignment or mask")
        out["differ_px"] += int(differ.sum())
        for key in ("mask", "reg_weight"):
            assert torch.equal(th[f"{key}_s{s}"][keep],
                               td[f"{key}_s{s}"][keep]), (s, key)
        both = keep & a_h & a_d
        rh, rd = th[f"reg_target_s{s}"], td[f"reg_target_s{s}"]
        for dim in range(rh.shape[-1]):
            err = float((rh[..., dim] - rd[..., dim])[both].abs().max()
                        ) if both.any() else 0.0
            j = dim % 8
            out["reg_err"][j] = max(out["reg_err"][j], err)
            assert err <= REG_TOL[j], (s, dim, err)
        perr = float((th[f"pc_s{s}"] - td[f"pc_s{s}"]).abs().max())
        out["pc_err"] = max(out["pc_err"], perr)
        assert perr <= PC_BAND, (s, perr)
        # 1 / (points in the pixel's box): a count moves only by pixels
        # of the face band crossing the box's faces
        nh = (1 / th[f"reg_norm_weight_s{s}"].amax(-1)[both]).round()
        nd = (1 / td[f"reg_norm_weight_s{s}"].amax(-1)[both]).round()
        shift = int((nh - nd).abs().max()) if both.any() else 0
        out["count_shift"] = max(out["count_shift"], shift)
        assert shift <= n_face, (s, shift, n_face)
    for k in range(cfg.num_classes):
        cerr = float((th[f"gt_corners_cls{k}"]
                      - td[f"gt_corners_cls{k}"]).abs().max())
        out["corner_err"] = max(out["corner_err"], cerr)
        assert cerr <= 1e-4, (k, cerr)
    return out


def saved_state_diff(a, b):
    """The entries in which two ``quality_probe --save`` files differ, by
    path ("model/<name>", "optimizer/state/<i>/<name>",
    "optimizer/param_groups/...", "step"): every tensor bit for bit (dtype,
    shape, bits), every other value by ``==``."""
    import torch

    def flat(x, path, out):
        if isinstance(x, dict):
            for k, v in x.items():
                flat(v, f"{path}/{k}" if path else str(k), out)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                flat(v, f"{path}/{i}", out)
        else:
            out[path] = x
        return out

    def bits(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    def same(x, y):
        if torch.is_tensor(x) or torch.is_tensor(y):
            return (torch.is_tensor(x) and torch.is_tensor(y)
                    and x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(bits(x), bits(y)))
        return x == y

    fa, fb = (flat(torch.load(p, map_location="cpu", weights_only=True),
                   "", {}) for p in (a, b))
    return sorted(k for k in fa.keys() | fb.keys()
                  if k not in fa or k not in fb or not same(fa[k], fb[k]))


def phase11(torch, m, cfg, dev, per_step, loader):
    """Device-side data and the training probes on the recipe at full size:
    (a) the raytracer on the card (vehicles; three families with clutter)
    against itself on the CPU on the same draws, the census, ms a batch
    beside the host make_batch's; (b) the packed cache of CACHE_FRAMES
    files: MB a frame, expand / augment_raw against record_to_inputs (with
    the host augmentation under matched draws) within the codec's budgets,
    the train targets outside the codec's band; (c) tools.train
    --device-cache --device-augment flip,rotation: an epoch of CACHE_STEPS
    steps under torch.profiler (launches, host-to-device bytes a step),
    then --resume with a cached validation (launches, the draws of an
    unbroken run), then an epoch like [10]'s of the recipe from the
    files, cached, its step ms beside [10]'s loader; (d) quality_probe for
    PROBE_STEPS steps with PROBE_HOLDOUT held-out frames, --save, an
    eval-only --resume whose --save is bit-equal to the file it read, and
    overfit_probe. ``per_step``: phase 6's
    launches of one train step; ``loader``: phase 10's ``steady_ms``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    sd, dc = m["synthetic_device"], m["device_cache"]
    train_cli, qp = m["train_cli"], m["quality_probe"]
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()

    def fail(msg):
        raise SystemExit(f"[11] {msg}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    H, W = cfg.feat_size
    PW, MG = cfg.pad_field[1], cfg.max_gt_boxes
    n_fwd, n_meta = conv_launches(cfg)[0], meta_units(cfg)
    per_frame = dict.fromkeys(per_step, 0)  # one eval forward
    per_frame.update(fwd=n_fwd, meta_kernel_taps=n_meta)

    # (a) the raytracer
    scenes = {
        "vehicles": dict(num_boxes=10),
        "veh+ped+cyc, 4 clutter": dict(
            num_boxes=10, num_clutter=4,
            families=qp.scene_families(("veh", "ped", "cyc"), False)),
    }
    host_ms = _median_ms(lambda: m["make_batch"](
        cfg, 2, seed=SEED, num_boxes=10, style="vehicles"), iters=3,
        warmup=1)
    for name, kw in scenes.items():
        draws = sd.draw_scenes(torch.Generator(device=dev).manual_seed(SEED),
                               2, H, W, **kw)
        got = sd.render_scenes(draws, H, W, PW, MG, **kw)
        ref = sd.render_scenes({k: v.to(cpu) for k, v in draws.items()}, H,
                               W, PW, MG, **kw)
        flips, zero_az, bad = render_diff(
            {k: v.cpu().numpy() for k, v in got.items()},
            {k: v.numpy() for k, v in ref.items()})
        counts = [m["points_per_box"](m["assign"](
            got["pc"][f].reshape(-1, 3),
            m["csa_to_corners3d"](got["gt_csa"][f]),
            got["mask"][f].reshape(-1), box_valid=got["gt_valid"][f]), MG)
            for f in range(2)]
        census = all(torch.equal(c, got["gt_num_points"][f])
                     for f, c in enumerate(counts))
        ms = _median_ms(lambda: sd.make_batch_device(
            torch.Generator(device=dev).manual_seed(SEED), 2, H, W, PW, MG,
            **kw))
        classes = sorted(set(got["gt_class"][got["gt_valid"] > 0].tolist()))
        print(f"[11] (a) raytracer, {name}, B=2 at {H}x{W} (pad {PW}): "
              f"card vs CPU on the same draws: {flips} face pixels flip "
              f"(gate {FACE_FLIP_FRAC:g} of {2 * H * W}), {zero_az} dropped "
              f"pixels' azimuth from signed zeros, all else within "
              f"{RENDER_TOL:g} relative: {not bad}; census (assigner counts "
              f"= gt_num_points, {int(sum(c.sum() for c in counts))} "
              f"points in {int(got['gt_valid'].sum())} boxes, classes "
              f"{classes}): {census}; {ms:.2f} ms a batch on the card "
              f"(median of 10), host make_batch(style=vehicles) "
              f"{host_ms:.1f} ms")
        if bad or flips > FACE_FLIP_FRAC * 2 * H * W or not census:
            fail(f"(a) {name}: keys {bad}, {flips} flips, census {census}")

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        recs = m["write_waymo_files"](data, CACHE_FRAMES, H=H, W=W,
                                      seed=SEED + 3, image_set="training",
                                      num_boxes=20)
        m["write_waymo_files"](data, 2, H=H, W=W, seed=SEED + 4,
                               image_set="validation", num_boxes=20)

        # (b) the cache against the host path
        cache, data_w, mb, map_s, put_s = train_cli.stage_frames(recs, cfg,
                                                                 dev)
        r2i = m["record_to_inputs"]
        full = r2i(recs[0], cfg.pad_field, MG)
        full_mb = sum(v.nbytes for v in full.values()) / 1e6
        print(f"[11] (b) {CACHE_FRAMES} frames packed and staged: "
              f"{mb / CACHE_FRAMES:.3f} MB a frame against {full_mb:.3f} MB "
              f"of record_to_inputs' f32 dict ({full_mb * CACHE_FRAMES / mb:.2f}x"
              f"); map {map_s:.2f} s, transfer {put_s:.3f} s")
        pick = [3, 8, 12, 15]
        idx = torch.tensor(pick, device=dev)
        host = [r2i(recs[i], cfg.pad_field, MG) for i in pick]
        host = {k: np.stack([h[k] for h in host]) for k in full}
        got = {k: v.cpu().numpy() for k, v in dc.expand_inputs(
            dc.gather_packed(cache, idx), data_w).items()}
        plain_err = codec_check(host, got)
        flips, shifts = [], []
        for i in range(len(pick)):
            r = np.random.RandomState(AUG_SEED0 + i)
            flips.append(bool(r.uniform() < 0.5))
            theta = float(r.uniform(-np.pi / 4, np.pi / 4))
            shifts.append(int(round(theta / (2 * np.pi) * data_w)))
        haug = [r2i(recs[i], cfg.pad_field, MG, augment=("flip", "rotation"),
                    aug_rng=np.random.RandomState(AUG_SEED0 + j))
                for j, i in enumerate(pick)]
        haug = {k: np.stack([h[k] for h in haug]) for k in haug[0]}
        raw = dc.augment_raw(
            dc.unpack_raw(dc.gather_packed(cache, idx), data_w), data_w,
            do_flip=torch.tensor(flips, device=dev),
            shift=torch.tensor(shifts, dtype=torch.int32, device=dev))
        aug = dc.finalize_inputs(raw)
        aug_err = codec_check(haug, {k: v.cpu().numpy()
                                     for k, v in aug.items()}, rotated=True)
        print(f"[11] (b) frames {pick}: expand_inputs vs record_to_inputs, "
              f"largest error a normalized channel "
              + " ".join(f"{e:.2e}" for e in plain_err)
              + f"; augment_raw (flips {flips}, shifts {shifts}) vs the host "
              f"augmentation under the matched RandomState draws "
              + " ".join(f"{e:.2e}" for e in aug_err)
              + " (within CHANNEL_TOL)")
        tc = cached_targets_check(
            torch, m["build_train_targets"], cfg,
            {k: torch.from_numpy(v).to(dev) for k, v in haug.items()}, aug)
        print(f"[11] (b) build_train_targets on the device-augmented batch vs "
              f"the host-augmented one: {tc['differ_px']} strided pixels "
              f"differ in assignment or mask, all within the codec's band "
              f"({tc['band_face_px']} pixels within {PC_BAND * 1e3:.2f} mm of "
              f"a box face, {tc['band_bound_px']} within "
              f"{RANGE_BAND * 1e3:.2f} mm of an FPN interval bound); "
              f"elsewhere masks and weights equal, reg targets' largest "
              f"error a dim " + " ".join(f"{e:.1e}" for e in tc["reg_err"])
              + f", points {tc['pc_err']:.1e}, box counts apart by <= "
              f"{tc['count_shift']}, GT corners {tc['corner_err']:.1e}")
        del cache, host, got, haug, raw, aug

        # (c) the train CLI's cached path
        exp = os.path.join(tmp, "exp")
        argv = ["--config", RECIPE, "--data-root", data, "--sampling-rate",
                "1", "--batch", "2", "--steps-per-epoch", str(CACHE_STEPS),
                "--experiment-dir", exp, "--device", dev.type,
                "--device-cache", "--device-augment", "flip,rotation"]
        draws, inside = [], []
        real_draw = dc.draw_augment
        real_make = m["make_train_step"]
        real_val = train_cli.build_validation

        def draw(*a, **kw):
            out = real_draw(*a, **kw)
            draws.append(tuple(t.tolist() for t in out))
            return out

        def ranged_make(state, c, group=None):
            step = real_make(state, c, group)

            def ranged(batch):
                with torch.profiler.record_function("chip_smoke_step"):
                    return step(batch)
            return ranged

        def counted_validation(*a, **kw):
            run = real_val(*a, **kw)

            def counted():
                sync()
                before = read_counts(m)
                out = run()
                sync()
                inside.append({k: v - before[k]
                               for k, v in read_counts(m).items()})
                return out
            return counted

        def run_cli(*extra):
            out = io.StringIO()
            sync()
            reset_counts(m)
            with mock.patch.object(dc, "draw_augment", draw), \
                    mock.patch.object(m["train_step"], "make_train_step",
                                      ranged_make), \
                    mock.patch.object(train_cli, "build_validation",
                                      counted_validation), \
                    contextlib.redirect_stdout(out):
                hist, state, val = train_cli.main(argv + list(extra))
            sync()
            n_val = len(inside)
            ev = {k: sum(d[k] for d in inside) for k in per_step}
            inside.clear()
            total = read_counts(m)
            return (hist, state, val, out.getvalue(),
                    {k: total[k] - ev[k] for k in per_step}, ev, n_val)

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            hist0, _, _, text0, tr0, _, _ = run_cli("--epochs", "1")
        trace_path = os.path.join(tmp, "cached_steps.json")
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            trace = json.load(f)["traceEvents"]
        tr = trace_in_ranges(trace, {"chip_smoke_step",
                                     "device_cache_batch"})
        tb = trace_in_ranges(trace, {"device_cache_batch"})
        n_kernels = sum(1 for e in trace if e.get("cat") == "kernel")
        del trace, prof
        hist1, state, val, text1, tr1, ev, n_val = run_cli(
            "--epochs", "2", "--resume", "--eval-every", "1",
            "--eval-frames", "2")
        hist = hist0 + hist1
        staged = [ln for ln in text0.splitlines() if "device cache staged" in ln]
        want = {k: CACHE_STEPS * v for k, v in per_step.items()}
        want_val = {k: 2 * v for k, v in per_frame.items()}
        unbroken = [tuple(t.tolist() for t in real_draw(
            2, data_w, train_cli.augment_generator(0, n, dev)))
            for n in range(2 * CACHE_STEPS)]
        vals = [v for mt in val.get(1, {}).values() for v in mt.values()]
        print(f"[11] (c) tools.train --device-cache --device-augment "
              f"flip,rotation, {CACHE_FRAMES} files, B=2: "
              f"{staged[0].split('INFO ')[-1] if staged else 'no staging line'}"
              f"; epoch 0 ({CACHE_STEPS} steps, under torch.profiler: "
              f"{n_kernels} kernel events), then --resume: "
              f"{'resumed from epoch 0' in text1}, epoch 1 ({CACHE_STEPS} "
              f"steps) and a cached validation of 2 frames "
              f"{json.dumps(val.get(1))}; launches of each run's steps "
              f"{CACHE_STEPS} x [6]'s per step: {tr0 == want and tr1 == want}"
              f", the validation's 2 x (conv {n_fwd}, taps {n_meta}): "
              f"{ev == want_val}; total_loss "
              + " ".join(f"{h['total_loss']:.4f}" for h in hist))
        print(f"[11] (c) draws (flips; shifts) of steps 0..{len(draws) - 1}: "
              + " | ".join(f"{d[0]}; {d[1]}" for d in draws)
              + f"; = an unbroken run's (seeded by (seed + 7, step)): "
              f"{draws == unbroken}")
        h2d = tr["h2d_bytes"] / CACHE_STEPS
        print(f"[11] (c) host-to-device copies launched inside the "
              f"{CACHE_STEPS} profiled steps (batch build + step): "
              f"{tr['h2d']} copies, {tr['h2d_bytes']} bytes = {h2d:.0f} "
              f"bytes a step (gate {H2D_STEP_MAX}; a full f32 frame is "
              f"{full_mb * 1e6:.0f}); their {tr['memcpy_calls']} runtime "
              f"memcpy calls of any direction, {tr['matched']} matched to "
              f"their device copy: {tr['kinds']}; {tr['all_h2d']} "
              f"host-to-device copies in the whole run (staging, weights, "
              f"scalars). The batch build on the card adds "
              f"{tb['launches'] / CACHE_STEPS:.0f} kernel launches and "
              f"{tb['kernel_us'] / CACHE_STEPS / 1e3:.3f} ms of device time "
              f"a step (under the profiler)")
        if (len(hist) != 2 * CACHE_STEPS or state.step != 2 * CACHE_STEPS
                or not all(math.isfinite(h["total_loss"]) for h in hist)):
            fail(f"(c) steps {[h['step'] for h in hist]}, losses "
                 f"{[h['total_loss'] for h in hist]}")
        if not staged or "resumed from epoch 0" not in text1:
            fail("(c) no staging line or no resume marker")
        if tr0 != want or tr1 != want:
            fail(f"(c) launches {tr0} / {tr1}, expected {want}")
        if n_val != 1 or ev != want_val or not vals or not all(
                math.isfinite(v) for v in vals):
            fail(f"(c) validation {val}, launches {ev}, expected {want_val}")
        if draws != unbroken:
            fail(f"(c) draws {draws}, an unbroken run {unbroken}")
        if h2d >= H2D_STEP_MAX:
            fail(f"(c) {h2d:.0f} host-to-device bytes a step")
        # the staging's copies must show, and each memcpy call of the
        # steps its device copy, or the count above would be vacuous
        if dev.type == "cuda" and (tr["all_h2d"] == 0 or tr["matched"]
                                   < tr["memcpy_calls"] or not tb["launches"]):
            fail(f"(c) the trace: {tr}, the batch build {tb}")
        # run 3: an epoch like [10]'s (the recipe from 16 files, 8 steps,
        # one window sync at its end), cached, for the step times
        with contextlib.redirect_stdout(io.StringIO()):
            hist3, _, _ = train_cli.main(
                ["--config", RECIPE, "--data-root", data, "--sampling-rate",
                 "1", "--batch", "2", "--epochs", "1", "--experiment-dir",
                 os.path.join(tmp, "exp3"), "--device", dev.type,
                 "--device-cache", "--device-augment", "flip,rotation"])
        mine = steady_ms(hist3)
        print(f"[11] (c) steady state, steps 2..{len(hist3)} of an epoch of "
              f"the recipe from the {CACHE_FRAMES} files, B=2, cached with "
              f"device augmentation: data_ms median {mine['data_ms']:.2f}, "
              f"step_ms median {mine['step_ms']:.2f} (the batch built on the "
              f"card and the step, dispatched), mean wall "
              f"{mine['wall_ms']:.2f} ms a step; [10]'s loader epoch of its "
              f"16 files at 2 workers ({loader['n']} steps): "
              f"{loader['data_ms']:.2f} / {loader['step_ms']:.2f} / "
              f"{loader['wall_ms']:.2f} ms; cached / loader step_ms "
              f"{mine['step_ms'] / max(loader['step_ms'], 1e-9):.3f}")

        # (d) the probes
        save = os.path.join(tmp, "probe.pt")
        common = ["--config", RECIPE, "--device", dev.type, "--steps",
                  str(PROBE_STEPS), "--eval-every", str(PROBE_STEPS),
                  "--holdout-frames", str(PROBE_HOLDOUT)]
        n_eval = -(-PROBE_HOLDOUT // 4)  # held-out batches of 4

        def probe(mod, args):
            out = io.StringIO()
            sync()
            reset_counts(m)
            with contextlib.redirect_stdout(out):
                recs_ = mod.main(args)
            sync()
            lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
            if lines != recs_:
                fail(f"(d) {mod.__name__}: printed lines {lines} != "
                     f"records {recs_}")
            return recs_, read_counts(m)

        recs_q, lq = probe(qp, common + ["--log-every", "10", "--save", save])
        steps_q = [r for r in recs_q if "step" in r]
        last = steps_q[-1] if steps_q else {}
        ap_keys = {k: v for k, v in last.items()
                   if k.startswith(("bev_", "l1_", "l2_"))}
        # an eval forward launches per_frame's kernels at any batch
        want_q = {k: PROBE_STEPS * per_step[k] + n_eval * per_frame[k]
                  for k in per_step}
        print(f"[11] (d) quality_probe, {PROBE_STEPS} steps at "
              f"{H}x{W}, B=2, a fresh raytraced scene a step: "
              + " ".join(json.dumps(r) for r in recs_q))
        # the rescore saves what it resumed: bit-equal to the file it read
        # iff --resume restored the model, the optimizer and the step count
        save_r = os.path.join(tmp, "probe_rescore.pt")
        recs_r, lr = probe(qp, common + ["--stop-after", "0", "--resume",
                                         save, "--step0", str(PROBE_STEPS),
                                         "--save", save_r])
        rescored = {k: v for k, v in recs_r[0].items() if k != "step"}
        saved = torch.load(save, map_location="cpu", weights_only=True)
        n_opt = len(saved["optimizer"]["state"])
        state_diff = saved_state_diff(save, save_r)
        recs_o, lo = probe(m["overfit_probe"], [
            "--config", RECIPE, "--device", dev.type, "--steps", "3",
            "--log-every", "1", "--eval-every", "3", "--style", "vehicles"])
        steps_o = [r for r in recs_o if "step" in r]
        print(f"[11] (d) quality_probe --stop-after 0 --resume: "
              f"{json.dumps(recs_r[0])}, = the last record's AP keys: "
              f"{rescored == ap_keys}; its --save against the file it "
              f"resumed ({len(saved['model'])} model tensors, the optimizer "
              f"state of {n_opt} parameters, step {saved['step']}): "
              f"entries that differ {state_diff}; overfit_probe 3 steps on "
              f"2 fixed frames: " + " ".join(json.dumps(r) for r in recs_o))
        print(f"[11] (d) s_per_step (host clock, the first step's set-up "
              f"and the eval included): quality_probe "
              f"{last.get('s_per_step')}, overfit_probe "
              f"{steps_o[-1]['s_per_step'] if steps_o else None}; launches "
              f"of the probe: {PROBE_STEPS} x [6]'s step + {n_eval} eval "
              f"batches of 4: {lq == want_q}")
        if (not last or last["step"] != PROBE_STEPS or len(ap_keys) < 7
                or not all(math.isfinite(v) for v in last.values())):
            fail(f"(d) quality_probe records {recs_q}")
        if rescored != ap_keys:
            fail(f"(d) the eval-only rescore {rescored} != {ap_keys}")
        if state_diff or saved["step"] != PROBE_STEPS or not n_opt:
            fail(f"(d) --resume did not restore the saved state: "
                 f"{state_diff}, step {saved['step']}, {n_opt} optimizer "
                 f"states")
        if lq != want_q:
            fail(f"(d) quality_probe launches {lq}, expected {want_q}")
        want_r = {k: n_eval * per_frame[k] for k in per_step}
        if lr != want_r:
            fail(f"(d) rescore launches {lr}, expected {want_r}")
        okeys = {"step", "loss", "s_per_step", "bev_ap_05", "bev_recall",
                 "ap3d_07", "recall3d_07", "l1_ap", "l1_aph"}
        if ([r["step"] for r in steps_o] != [1, 2, 3]
                or set(steps_o[-1]) != okeys
                or not all(math.isfinite(r["loss"]) for r in steps_o)):
            fail(f"(d) overfit_probe records {recs_o}")
        want_o = {k: 3 * per_step[k] + per_frame[k] for k in per_step}
        if lo != want_o:
            fail(f"(d) overfit_probe launches {lo}, expected {want_o}")
    print(f"[11] phase 11 in {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------- phase 12
RANKS = 2  # processes of [12](c), both on the one card, over gloo
DP_STEPS = 2  # steps of each two-rank run
DP_TIMED = 5  # more steps of the sync run, timed
RANK_TIMEOUT = 600
# gates of [12](c), two ranks of B=1 against one process of B=2 in bf16 on
# the card, after each of DP_STEPS steps (``dp_spread``): the losses' max
# relative difference, and over the parameters and running statistics the
# median and the max of their update's (new - init) max|a - b| / max|b|.
# From (b)'s weights (BatchNorms perturbed, ``perturb_bn``), on an NVIDIA
# H100 80GB HBM3 at 700.00 W (PERF.md section 6), after steps 1 / 2: the
# same B=2 step with its two frames swapped, which only reorders the sums,
# reads losses 0.0010 / 0.0040, median 0.186 / 0.247, max 1.60 / 1.70; two
# ranks 0.0002 / 0.0062, 0.190 / 0.255, 1.26 / 1.59; the planted fault
# keeping half of the other rank's cotangent 0.0002 / 0.0104, 0.406 /
# 0.511, 10.5 / 10.3; keeping none 0.0002 / 0.0257, 0.545 / 0.712, 20.9 /
# 20.9. bf16 moves any reordering that far; the perturbation did not
# narrow it (unperturbed: median 0.197 / 0.246, max 1.30 / 2.05). The
# spreads repeat from call to call, the kernels being deterministic. The
# gates sit between the floor and the half fault, and [12](c) holds the
# swapped frames to them too.
DP_LOSS_TOL = 1e-2
DP_UPDATE_MEDIAN_TOL = 0.35
DP_UPDATE_MAX_TOL = 4.0
# the second planted fault keeps this share of the other rank's cotangent
DP_FAULT_KEPT = 0.5
# localbn against the mean of two one-process B=1 steps: the same kernels
# on the same rows, so only the all-reduce's rounding separates them
DP_LOCAL_TOL = 1e-5


def free_port():
    """A TCP port of 127.0.0.1 that is free now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def planted_detached_sum(kept=0.0):
    """The BatchNorms' all-reduce with its backward (partly) detached: the
    forward sums over the group, the backward keeps each rank's own
    cotangent of the sums and ``kept`` of the other ranks' share. The
    planted faults of [12](c) and of the CPU tests (``kept`` 0)."""
    from rangedet_tpu_torch.parallel.dist import AllReduceSum

    class Detached(AllReduceSum):
        @staticmethod
        def backward(ctx, g):
            if not kept:
                return g, None
            total, _ = AllReduceSum.backward(ctx, g)
            return g + kept * (total - g), None

    return lambda x, group: Detached.apply(x, group)


def planted_halo(kind):
    """The width halo's Function with a planted fault: "halo_zeros", the
    forward receiving zeros for the neighbours' columns (its backward
    unchanged); "halo_grad", the backward dropping the gradient the
    neighbours return (its forward unchanged). The planted faults of [13]
    and of the CPU tests."""
    import torch

    from rangedet_tpu_torch.parallel.halo import WidthHalo

    class Zeros(WidthHalo):
        @staticmethod
        def forward(ctx, x, h, group):
            ctx.h, ctx.group = h, group
            pad = x.new_zeros(x.shape[:-1] + (h,))
            return torch.cat([pad, x, pad], dim=-1)

    class DropGrad(WidthHalo):
        @staticmethod
        def backward(ctx, g):
            return g[..., ctx.h:-ctx.h].contiguous(), None, None

    return {"halo_zeros": Zeros, "halo_grad": DropGrad}[kind]


def planted(spec):
    """The context of a run's planted fault: ``fault`` (the BatchNorms'
    all-reduce with its backward keeping ``kept`` of the other ranks'
    cotangent, [12]) or ``plant`` ("halo_zeros", "halo_grad", or "counts":
    the targets' per-box point counts not summed over the width group,
    [13])."""
    from rangedet_tpu_torch.models import layers
    from rangedet_tpu_torch.ops import targets
    from rangedet_tpu_torch.parallel import halo

    if spec.get("fault"):
        return mock.patch.object(layers, "all_reduce_sum",
                                 planted_detached_sum(spec.get("kept", 0.0)))
    kind = spec.get("plant")
    if kind == "counts":
        return mock.patch.object(targets, "all_reduce_sum", lambda x, g: x)
    if kind:
        return mock.patch.object(halo, "WidthHalo", planted_halo(kind))
    return contextlib.nullcontext()


def rank_main(spec_path):
    """One rank of a multi-process run (``start_ranks``): join the group the
    spec names and place it on the spec's ``mesh`` ({"data": D, "model":
    M}, default all on data), then with ``mode`` "ops" run
    ``width_op_runs``; else for each of the spec's ``runs`` (a dict of spec
    keys each, or the
    spec alone) take this rank's rows (and columns) of the spec's global
    batch and run ``steps`` steps of ``train_step.build_train_step_fn``'s
    step from the spec's weights (``mode`` "sync" or "local"; a planted
    fault, ``planted``), counting each step's kernel launches and
    collectives (with ``keep_step1``, keeping step 1's targets, forward
    outputs and feature gradients), then on the card time ``timed`` more
    steps; save the metrics, the state after each counted step, the
    counts, what was kept, the median step ms and the peak memory (by run
    name with ``runs``; with ``op_seed`` also ``width_op_runs``' under
    "ops") to ``out``."""
    import torch

    from rangedet_tpu_torch.parallel import dist as pd

    spec = torch.load(spec_path, weights_only=False)
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    ranks = pd.join(spec["device"], backend=spec["backend"],
                    rank=spec["rank"], world_size=spec["world"],
                    init_method=spec["init_method"], always=True)
    mesh = spec.get("mesh") or {"data": ranks.world, "model": 1}
    ranks = pd.with_mesh(ranks, mesh["data"], mesh["model"])
    if spec["mode"] == "ops":
        out = width_op_runs(torch, spec, ranks)
    elif "runs" in spec:
        out = {run["name"]: rank_run(torch, dict(spec, **run), ranks)
               for run in spec["runs"]}
        if spec.get("op_seed") is not None:
            out["ops"] = width_op_runs(torch, spec, ranks)
    else:
        out = rank_run(torch, spec, ranks)
    torch.save(out, spec["out"])
    pd.leave(ranks)


def keep_step1(model, out):
    """Hooks that keep step 1's logits and deltas (``out["outputs"]``, one
    tensor a level each) and the gradients of the backbone's features
    (``out["grads"]``), on the host in f32. -> the hooks."""
    out["outputs"], out["grads"] = None, {}

    def outputs(module, args, result):
        if out["outputs"] is None:
            out["outputs"] = [t.detach().float().cpu()
                              for t in result[0] + result[1]]

    def features(module, args, result):
        if out["grads"]:
            return
        for i, t in enumerate(result):
            out["grads"][i] = None

            def keep(g, i=i):
                if out["grads"][i] is None:
                    out["grads"][i] = g.detach().float().cpu()

            t.register_hook(keep)

    return [model.register_forward_hook(outputs),
            model.backbone.register_forward_hook(features)]


def rank_run(torch, spec, ranks):
    """One run of ``rank_main`` in the group ``ranks`` joined."""
    from rangedet_tpu_torch.models import RangeDet, layers
    from rangedet_tpu_torch.ops import conv3x3, iou_target, meta_block
    from rangedet_tpu_torch.ops import meta_kernel
    from rangedet_tpu_torch.parallel import dist as pd
    from rangedet_tpu_torch.train import train_step
    from rangedet_tpu_torch.train.state import create_train_state
    from rangedet_tpu_torch.train.train_step import (
        batch_to_device,
        build_train_step_fn,
    )

    dev = ranks.device
    cuda = dev.type == "cuda"
    width = ranks.width_group
    cfg = spec["cfg"].replace(sync_bn=spec["mode"] == "sync",
                              width_axis="model" if width else None)
    model = RangeDet(**cfg.model_kwargs())
    model.load_state_dict(spec["state"])
    model = model.to(dev)
    layers.set_sync_group(model, ranks.group if cfg.sync_bn else None)
    layers.set_width_group(model, width)
    state = create_train_state(model, cfg, STEPS_PER_EPOCH, seed=None)
    step = build_train_step_fn(state, cfg, ranks.group, width)
    batch = batch_to_device(pd.local_rows(
        spec["batch"], ranks.data_index, ranks.n_data, ranks.width_index,
        ranks.n_width), dev)
    mods = dict(conv3x3=conv3x3, iou=iou_target, meta=meta_block,
                taps=meta_kernel)
    out = dict(bn_semantics=step.bn_semantics, metrics=[], states=[],
               launches=[], collectives=[])

    hooks, real_targets = [], train_step.build_train_targets

    def targets(*args):
        t = real_targets(*args)
        out.setdefault("targets", {k: v.cpu() for k, v in t.items()})
        return t

    keep = contextlib.nullcontext()
    if spec.get("keep_step1"):
        hooks = keep_step1(model, out)
        keep = mock.patch.object(train_step, "build_train_targets", targets)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with planted(spec), keep:
        for _ in range(spec["steps"]):
            if cuda:
                torch.cuda.synchronize(dev)
            reset_counts(mods)
            pd.reset_counts()
            metrics = step(batch)
            if cuda:
                torch.cuda.synchronize(dev)
            out["launches"].append(read_counts(mods))
            out["collectives"].append(pd.COLLECTIVES)
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            out["states"].append({k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()})
        for h in hooks:
            h.remove()
        if cuda and spec.get("timed"):
            out["step_ms"] = _median_ms(lambda: step(batch),
                                        iters=spec["timed"], warmup=1)
            out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def seam_boxes(torch, batch, n_width):
    """The boxes of a host batch whose assigned points (the full frame's
    assignment, ``ops/assigner.py``) lie on both sides of a seam between
    width shards, columns k*W/M: -> [(frame, box, points left of the seam,
    points right of it)]. Only such a box's 1/N weights tell a count summed
    over the width group from one that is not."""
    from rangedet_tpu_torch.ops.assigner import assign_points_to_boxes
    from rangedet_tpu_torch.ops.boxes import csa_to_corners3d

    B, H, W = batch["pc"].shape[:3]
    cols = torch.arange(W).repeat(H)
    found = []
    for b in range(B):
        pc = torch.as_tensor(batch["pc"][b]).float()
        gt = torch.as_tensor(batch["gt_csa"][b]).float()
        nlz = batch.get("is_in_nlz")
        a = assign_points_to_boxes(
            pc.reshape(-1, 3), csa_to_corners3d(gt),
            torch.as_tensor(batch["mask"][b]).float().reshape(-1),
            box_valid=torch.as_tensor(batch["gt_valid"][b]),
            is_in_nlz=(torch.full((H * W,), -1.0) if nlz is None else
                       torch.as_tensor(nlz[b]).float().reshape(-1)))
        for k in range(1, n_width):
            seam = k * W // n_width
            for box in a[a >= 0].unique().tolist():
                c = cols[a == box]
                left, right = int((c < seam).sum()), int((c >= seam).sum())
                if left and right:
                    found.append((b, box, left, right))
    return found


def _columns(t, ranks):
    """Rank m's columns [m*W/M, (m+1)*W/M) of t's last axis."""
    w = t.shape[-1] // ranks.n_width
    return t[..., ranks.width_index * w:(ranks.width_index + 1) * w]


def width_op_case(torch, kind, cols, whole, stride, group, dev):
    """One width op of the port on ``dev`` with the width group ``group``
    (None: the unsharded op): "conv" (``layers.conv3x3_width``, x and the
    cotangent r in ``cols``, the (Co, Ci, 3, 3) weight in ``whole``),
    "deconv" (``layers.deconv_width``, weight (Ci, Co, 3, 2s) in x's dtype)
    or "meta" (the ``MetaKernel`` module, kernel 7 on the card: feat,
    coords (B, H, 3, W) and r in ``cols``, its MLP in ``whole``). ->
    (output, {name: gradient of sum(output * r)}) on the host."""
    from rangedet_tpu_torch.models import layers
    from rangedet_tpu_torch.models.meta_kernel import MetaKernel

    c = {k: v.to(dev).clone().requires_grad_(k not in ("r", "coords"))
         for k, v in cols.items()}
    w = {k: v.to(dev).clone().requires_grad_(True) for k, v in whole.items()}
    dtype = c["x" if "x" in c else "feat"].dtype
    if kind == "conv":
        y = (layers.conv3x3_consume(c["x"], w["weight"], stride, dtype)[0]
             if group is None else layers.conv3x3_width(
                 c["x"], w["weight"], stride, dtype, group))
    elif kind == "deconv":
        y = (layers.deconv_bhcw(c["x"], w["weight"], stride)
             if group is None else layers.deconv_width(
                 c["x"], w["weight"], stride, group))
    else:
        mk = MetaKernel((w["w0"].shape[0], c["feat"].shape[2]), dtype,
                        use_pallas_meta=True).to(dev)
        with torch.no_grad():
            for name, t in (("mlp0.weight", "w0"), ("mlp0.bias", "b0"),
                            ("mlp1.weight", "w1"), ("mlp1.bias", "b1")):
                mk.get_parameter(name).copy_(w[t])
        mk.width_group = group
        y = mk(c["feat"], c["coords"].permute(0, 1, 3, 2))
        w = dict(w0=mk.mlp0.weight, b0=mk.mlp0.bias, w1=mk.mlp1.weight,
                 b1=mk.mlp1.bias)
    (y.float() * c["r"].float()).sum().backward()
    grads = {k: t.grad.detach().cpu() for k, t in list(c.items())
             + list(w.items()) if t.grad is not None}
    return y.detach().cpu(), grads


def start_ranks(spec, world, tmp, name):
    """Start ``world`` processes of this script's ``rank_main`` on ``spec``
    (a group on a free port of 127.0.0.1). -> a handle for
    ``wait_ranks``."""
    import torch

    port = free_port()
    procs = []
    for r in range(world):
        path = os.path.join(tmp, f"{name}_rank{r}")
        torch.save(dict(spec, rank=r, world=world,
                        init_method=f"tcp://127.0.0.1:{port}",
                        out=f"{path}.out"), f"{path}.spec")
        log = open(f"{path}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             f"{path}.spec"], stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="1")), log, path))
    return name, procs


def wait_ranks(handle, timeout=RANK_TIMEOUT):
    """Wait for the processes of ``start_ranks`` (killing them all if one
    fails or the time runs out). -> each rank's saved output, by rank."""
    import torch

    name, procs = handle
    deadline = time.monotonic() + timeout
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(p.returncode for p, _, _ in procs):
        tails = []
        for p, _, path in procs:
            with open(f"{path}.log") as f:
                tails.append(f"rank {path[-1]} exit {p.returncode}:\n"
                             + f.read()[-3000:])
        raise RuntimeError(f"{name}: a rank failed\n" + "\n".join(tails))
    return [torch.load(f"{path}.out", weights_only=False)
            for _, _, path in procs]


def dp_spread(metrics, states, ref_metrics, ref_states, init):
    """How far a run lies from its reference after each step (lists of
    per-step metrics as floats, and of state dicts): the losses' max
    relative difference; each floating tensor's update (new - init) by
    max|a - b| / max|b|, as the median, the max and its name, and the head
    projections' max; the cosine of the parameters' whole updates."""
    import torch

    out = []
    for m, st, rm, rst in zip(metrics, states, ref_metrics, ref_states):
        rels, a, b = {}, [], []
        for k, v0 in init.items():
            if not v0.is_floating_point():
                continue
            d_got = st[k].double() - v0.double()
            d_ref = rst[k].double() - v0.double()
            rels[k] = float((d_got - d_ref).abs().max()
                            / d_ref.abs().max().clamp(min=1e-30))
            if "running_" not in k:
                a.append(d_got.flatten())
                b.append(d_ref.flatten())
        a, b = torch.cat(a), torch.cat(b)
        worst = max(rels, key=rels.get)
        out.append(dict(
            loss=max(abs(m[k] - rm[k]) / max(abs(rm[k]), 1e-30)
                     for k in rm),
            median=statistics.median(rels.values()), max=rels[worst],
            worst=worst, n=len(rels),
            head=max(r for k, r in rels.items() if "_lvl_" in k and (
                "cls_logit" in k or "reg_delta" in k)),
            cos=float(a @ b / (a.norm() * b.norm()))))
    return out


def dp_passes(spread):
    """The gates of [12](c): every step's losses, update median and
    update max."""
    return all(s["loss"] <= DP_LOSS_TOL
               and s["median"] <= DP_UPDATE_MEDIAN_TOL
               and s["max"] <= DP_UPDATE_MAX_TOL for s in spread)


def dp_line(spread):
    """The spread of each step, as text."""
    return "; ".join(
        f"step {i + 1}: losses {s['loss']:.4g}, update median "
        f"{s['median']:.4g}, max {s['max']:.4g} ({s['worst']}), head "
        f"projections {s['head']:.4g}, cosine {s['cos']:.6f}"
        for i, s in enumerate(spread))


def perturb_bn(torch, layers, model, seed):
    """Seeded noise on every BatchNorm's scale, bias and running
    statistics, as the CPU tests' ``torch_parity.perturb`` puts it on the
    weights they hold against JAX: scale x U(0.7, 1.3), bias and mean
    + 0.1 N(0, 1), var x U(0.5, 1.5). At the init's scale 1 and bias 0 the
    BatchNorm backward nearly cancels, and any reordering of a bf16 sum
    moves the gradient far."""
    g = torch.Generator().manual_seed(seed)

    def uniform(t, lo, hi):
        return torch.rand(t.shape, generator=g) * (hi - lo) + lo

    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, layers.BatchNormFold):
                bn.weight.mul_(uniform(bn.weight, 0.7, 1.3))
                bn.bias.add_(0.1 * torch.randn(bn.bias.shape, generator=g))
                bn.running_mean.add_(
                    0.1 * torch.randn(bn.running_mean.shape, generator=g))
                bn.running_var.mul_(uniform(bn.running_var, 0.5, 1.5))


def plain_steps(torch, m, cfg, dev, init_sd, batch, group=None,
                width_group=None, keep=False):
    """DP_STEPS steps of ``make_train_step`` (with the groups given, on the
    model's BatchNorms and width layers) from ``init_sd`` on ``batch``: ->
    {metrics (floats), states (on the host)} a step, and with ``keep``
    step 1's outputs and feature gradients (``keep_step1``)."""
    layers = m["layers"]
    model = m["RangeDet"](**cfg.model_kwargs())
    model.load_state_dict(init_sd)
    model = model.to(dev)
    layers.set_sync_group(model, group)
    layers.set_width_group(model, width_group)
    state = m["create_train_state"](model, cfg, STEPS_PER_EPOCH, seed=None)
    step = m["make_train_step"](state, cfg, group, width_group)
    out = dict(metrics=[], states=[])
    hooks = keep_step1(model, out) if keep else []
    for _ in range(DP_STEPS):
        out["metrics"].append({k: float(v) for k, v in step(batch).items()})
        out["states"].append({k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()})
    for h in hooks:
        h.remove()
    return out


def world1_check(torch, m, cfg, dev, init_sd, batch, backend):
    """The data-parallel step in sync mode in a group of one (``backend``)
    against the plain step, DP_STEPS steps from ``init_sd`` on ``batch``:
    -> (bit-equal, the plain run's metrics and states (on the host), the
    launches and collectives a step of each)."""
    pd, layers = m["pdist"], m["layers"]
    ranks = pd.join(str(dev), backend=backend, rank=0, world_size=1,
                    init_method=f"tcp://127.0.0.1:{free_port()}",
                    always=True)
    runs = {}
    try:
        for name in ("plain", "dp"):
            model = m["RangeDet"](**cfg.model_kwargs())
            model.load_state_dict(init_sd)
            model = model.to(dev)
            state = m["create_train_state"](model, cfg, STEPS_PER_EPOCH,
                                            seed=None)
            if name == "dp":
                layers.set_sync_group(model, ranks.group)
            step = m["make_train_step"](
                state, cfg, ranks.group if name == "dp" else None)
            r = runs[name] = dict(metrics=[], states=[], launches=[],
                                  collectives=[])
            for _ in range(DP_STEPS):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                reset_counts(m)
                pd.reset_counts()
                metrics = step(batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                r["launches"].append(read_counts(m))
                r["collectives"].append(pd.COLLECTIVES)
                r["metrics"].append({k: v.detach().clone()
                                     for k, v in metrics.items()})
                r["states"].append({k: v.detach().clone() for k, v in
                                    model.state_dict().items()})
    finally:
        pd.leave(ranks)
    a, b = runs["plain"], runs["dp"]
    same = all(torch.equal(x[k], y[k]) for x, y in zip(a["metrics"],
                                                       b["metrics"])
               for k in x) and all(
        torch.equal(x[k], y[k]) for x, y in zip(a["states"], b["states"])
        for k in x)
    host = [{k: v.cpu() for k, v in s.items()} for s in a["states"]]
    return same, [{k: float(v) for k, v in x.items()}
                  for x in a["metrics"]], host, a, b


def phase12(torch, m, cfg, dev, per_step):
    """Data-parallel training of the recipe at 64x2656 (``parallel/``):
    (a) one B=1 train step, every launch through phase 5's correctness
    gates (its speed printed, not gated) and the launches of phase 6's
    step; (b) the data-parallel step in sync mode in an NCCL group of one,
    DP_STEPS steps from phase 6's init with its BatchNorms perturbed and
    B=2 batch, bit-equal to the plain step (losses, parameters, running
    statistics), its collectives a step; (c) RANKS processes on the one
    card over gloo, each B=1 of that batch: sync mode against (b)'s plain
    step within the DP_* gates, both ranks bit-equal, the planted faults
    (the BatchNorm all-reduce's backward keeping none, or DP_FAULT_KEPT,
    of the other rank's cotangent) rejected by the same gates, localbn against the mean
    of two one-process B=1 steps, each rank's launches (phase 6's per
    step), median step ms and peak memory; (d) tools.train and tools.test
    under ``python -m torch.distributed.run --nproc_per_node 1`` (NCCL)
    from CACHE_FRAMES files: an epoch of 2 steps, a checkpoint, --resume,
    then the validation frames' pickle. -> the KernelTotals of (a) and the
    launches of a rank's step."""
    import numpy as np

    pd, layers = m["pdist"], m["layers"]
    t_phase = time.perf_counter()

    def fail(msg):
        raise SystemExit(f"[12] {msg}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    H, W = cfg.feat_size
    init = m["RangeDet"](**cfg.model_kwargs())
    init.init_from(torch.Generator().manual_seed(SEED))
    init_sd = {k: v.clone() for k, v in init.state_dict().items()}
    perturb_bn(torch, layers, init, SEED)  # the weights of (b) and (c)
    dp_sd = {k: v.clone() for k, v in init.state_dict().items()}
    del init

    # (a) the train kernels at B=1
    model = m["RangeDet"](**cfg.model_kwargs())
    model.load_state_dict(init_sd)
    state = m["create_train_state"](model.to(dev), cfg, STEPS_PER_EPOCH,
                                    seed=None)
    step = m["make_train_step"](state, cfg)
    batch1 = m["batch_to_device"](m["make_batch"](cfg, 1, seed=SEED,
                                                  num_boxes=20), dev)
    sync()
    reset_counts(m)
    step(batch1)
    sync()
    b1 = read_counts(m)
    print(f"[12] (a) one B=1 train step: launches {b1}")
    if b1 != per_step:
        fail(f"(a) B=1 launches {b1}, phase 6's step {per_step}")
    recorded = record_train_step(step, batch1, m["conv3x3"], m["iou"],
                                 layers, m["meta"])
    del model, state, step
    totals = phase5(torch, m["conv3x3"], m["iou"], layers, m["meta"],
                    m["taps"], recorded, H, dev, tag="12",
                    speed_gates=False)
    del recorded

    # (b) NCCL in a group of one
    batch_np = m["make_batch"](cfg, 2, seed=SEED, num_boxes=20)
    batch = m["batch_to_device"](batch_np, dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    same, ref_metrics, ref_states, plain, dp = world1_check(
        torch, m, cfg, dev, dp_sd, batch, backend)
    n_bn = sum(isinstance(x, layers.BatchNormFold)
               for x in m["RangeDet"](**cfg.model_kwargs()).modules())
    coll = dp["collectives"][-1]
    print(f"[12] (b) dp step, sync, {backend} group of one, {DP_STEPS} steps "
          f"against the plain step: losses, parameters and running "
          f"statistics bit-equal: {same}; total_loss "
          + " ".join(repr(x["total_loss"]) for x in ref_metrics)
          + f"; launches a step {dp['launches'][-1]} (plain "
          f"{plain['launches'][-1]}); collectives a step {coll} (plain "
          f"{plain['collectives'][-1]}): {n_bn} BatchNorms x 2 (their sums "
          f"forward and the sums' cotangent backward) + "
          f"{2 * len(cfg.fpn_strides)} loss normalizers + "
          f"{coll - 2 * n_bn - 2 * len(cfg.fpn_strides)} flat buffers "
          f"(gradients with the metrics, running statistics)")
    if not same:
        fail("(b) the dp step in a group of one differs from the plain step")
    if dp["launches"] != plain["launches"]:
        fail(f"(b) launches {dp['launches']} != {plain['launches']}")
    del plain, dp

    # (c) two processes on the one card over gloo
    spec = dict(cfg=cfg, state={k: v.cpu() for k, v in dp_sd.items()},
                batch=batch_np, steps=DP_STEPS,
                device=str(batch["input_data"].device), backend="gloo")
    init_host = spec["state"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = wait_ranks(start_ranks(dict(spec, mode="sync",
                                           timed=DP_TIMED), RANKS, tmp,
                                      "sync"))
        t1 = time.perf_counter()
        h_fault = start_ranks(dict(spec, mode="sync", fault=True), RANKS,
                              tmp, "fault")
        h_half = start_ranks(dict(spec, mode="sync", fault=True,
                                  kept=DP_FAULT_KEPT), RANKS, tmp, "half")
        h_local = start_ranks(dict(spec, mode="local", steps=1), RANKS, tmp,
                              "local")
        faults, halves = wait_ranks(h_fault), wait_ranks(h_half)
        locals_ = wait_ranks(h_local)
        t2 = time.perf_counter()
    print(f"[12] (c) {RANKS} ranks over gloo on {spec['device']}: sync run "
          f"{t1 - t0:.1f} s; the two faults' and localbn's runs together "
          f"{t2 - t1:.1f} s")
    for r, o in enumerate(outs):
        print(f"[12] (c) sync rank {r}: launches a step {o['launches'][-1]}"
              f", collectives a step {o['collectives'][-1]}, step median "
              f"{o.get('step_ms', 'not measured')} ms over {DP_TIMED} "
              f"steps, peak memory {o.get('peak_gib', 'not measured')} GiB")
        if o["launches"] != [per_step] * DP_STEPS:
            fail(f"(c) rank {r} launches {o['launches']}, phase 6's "
                 f"{per_step} a step")
    for name, o in (("sync", outs), ("fault", faults), ("half fault", halves),
                    ("local", locals_)):
        same = all(torch.equal(a[k], o[1]["states"][i][k])
                   for i, a in enumerate(o[0]["states"]) for k in a)
        print(f"[12] (c) {name}: both ranks' states bit-equal: {same}")
        if not same:
            fail(f"(c) {name}: the ranks' states differ")
    # the floor: the same B=2 step with its two frames swapped, which
    # only reorders the sums
    swapped = plain_steps(torch, m, cfg, dev, dp_sd,
                          {k: v.flip(0) for k, v in batch.items()})
    stat = {"swapped frames": dp_spread(swapped["metrics"],
                                        swapped["states"], ref_metrics,
                                        ref_states, init_host)}
    for name, o in (("sync", outs), ("fault", faults),
                    ("half fault", halves)):
        stat[name] = dp_spread(o[0]["metrics"], o[0]["states"],
                               ref_metrics, ref_states, init_host)
    for name, sp in stat.items():
        print(f"[12] (c) {name} vs one process of B=2 (total_loss "
              + " ".join(f"{x['total_loss']:.6f}" for x in ref_metrics)
              + f"): {dp_line(sp)}; gates, every step: losses <= "
              f"{DP_LOSS_TOL}, update median <= {DP_UPDATE_MEDIAN_TOL}, "
              f"max <= {DP_UPDATE_MAX_TOL}: "
              f"{'pass' if dp_passes(sp) else 'reject'}")
    if not (dp_passes(stat["sync"]) and dp_passes(stat["swapped frames"])):
        fail("(c) two ranks (or the swapped frames) vs one process outside "
             "the gates")
    if dp_passes(stat["fault"]) or dp_passes(stat["half fault"]):
        fail("(c) the gates pass a planted fault")

    # localbn: the mean of two one-process B=1 steps
    rows, grads, bufs = [], [], []
    for r in range(RANKS):
        model = m["RangeDet"](**cfg.model_kwargs())
        model.load_state_dict(dp_sd)
        model = model.to(dev).train()
        b = m["batch_to_device"](pd.local_rows(batch_np, r, RANKS), dev)
        targets = m["build_train_targets"](b, cfg)
        cls, reg = model(b["input_data"], b["coord"])
        total, metrics = m["compute_losses"](cls, reg, targets, cfg)
        total.backward()
        rows.append({k: float(v.detach()) for k, v in metrics.items()})
        grads.append([p.grad for p in model.parameters()])
        bufs.append({k: v.clone() for k, v in model.named_buffers()})
    model = m["RangeDet"](**cfg.model_kwargs())
    model.load_state_dict(dp_sd)
    model = model.to(dev)
    state = m["create_train_state"](model, cfg, STEPS_PER_EPOCH, seed=None)
    for p, *g in zip(model.parameters(), *grads):
        p.grad = None if g[0] is None else sum(g) / RANKS
    m["train_step"].apply_update(state, cfg)
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(sum(b[k] for b in bufs) / RANKS)
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    mean_rows = [{k: sum(r[k] for r in rows) / RANKS for k in rows[0]}]
    (s,) = dp_spread(locals_[0]["metrics"], locals_[0]["states"][:1],
                     mean_rows, [want], init_host)
    exact = all(torch.equal(want[k], locals_[0]["states"][0][k])
                for k in want)
    print(f"[12] (c) localbn vs the mean of two one-process B=1 steps and "
          f"one apply_update of their mean gradient: losses max rel diff "
          f"{s['loss']:.4g}, update max {s['max']:.4g} ({s['worst']}), "
          f"median {s['median']:.4g} (gate {DP_LOCAL_TOL}); bit-equal "
          f"{exact}; total_loss {locals_[0]['metrics'][0]['total_loss']:.6f}"
          f" = mean of {rows[0]['total_loss']:.6f} and "
          f"{rows[1]['total_loss']:.6f}")
    if not (s["loss"] <= DP_LOCAL_TOL and s["max"] <= DP_LOCAL_TOL):
        fail("(c) localbn differs from the mean of two B=1 steps")
    del model, state, grads, bufs

    # (d) the CLIs under the launcher
    repo = os.path.dirname(os.path.abspath(__file__))
    launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "-m"]
    env = dict(os.environ, PYTHONPATH=repo)

    def launch(args, what):
        t0 = time.perf_counter()
        p = subprocess.run(launcher + args, cwd=repo, env=env,
                           capture_output=True, text=True, timeout=600)
        out = p.stdout + p.stderr
        if p.returncode:
            fail(f"(d) {what} exit {p.returncode}:\n{out[-4000:]}")
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
        m["write_waymo_files"](data, CACHE_FRAMES, H=H, W=W, seed=SEED + 3,
                               image_set="training", num_boxes=20)
        m["write_waymo_files"](data, VAL_FRAMES, H=H, W=W, seed=SEED + 4,
                               image_set="validation", num_boxes=20)
        train = ["rangedet_tpu_torch.tools.train", "--config", RECIPE,
                 "--data-root", data, "--sampling-rate", "1", "--batch", "2",
                 "--num-workers", "2", "--steps-per-epoch", "2",
                 "--experiment-dir", exp, "--device", dev.type, "--multihost",
                 "--mesh", "data=1"]
        out1, s1 = launch(train + ["--epochs", "1"], "tools.train")
        out2, s2 = launch(train + ["--epochs", "2", "--resume"],
                          "tools.train --resume")
        ccfg = cfg.replace(experiment_dir=exp)
        pkl = os.path.join(tmp, "pred.pkl")
        out3, s3 = launch(["rangedet_tpu_torch.tools.test", "--config",
                           RECIPE, "--data-root", data, "--image-set",
                           "validation", "--batch", "1", "--experiment-dir",
                           exp, "--epoch", "1", "--device", dev.type,
                           "--multihost", "--output", pkl], "tools.test")
        epochs = m["latest_epoch"](ccfg)
        with open(pkl, "rb") as f:
            anno, preds = pickle.load(f), pickle.load(f)
    joined = f"1 rank(s), {backend}"
    print(f"[12] (d) under torch.distributed.run --nproc_per_node 1: "
          f"tools.train {s1:.1f} s ('{joined}' logged: {joined in out1}), "
          f"--resume {s2:.1f} s (resumed from epoch 0: "
          f"{'resumed from epoch 0' in out2}), latest checkpoint {epochs}; "
          f"tools.test {s3:.1f} s: {len(preds)} frames, "
          f"{sum(len(p['det_xyzlwhyaws']['veh']) for p in preds.values())} "
          f"detections")
    if joined not in out1 or "resumed from epoch 0" not in out2:
        fail(f"(d) the train CLI's log:\n{out1[-2000:]}\n{out2[-2000:]}")
    if epochs != 1 or len(preds) != VAL_FRAMES or len(anno) != VAL_FRAMES:
        fail(f"(d) checkpoint {epochs}, {len(preds)} predicted frames")
    for p in preds.values():
        d = p["det_xyzlwhyaws"]["veh"]
        if d.ndim != 2 or d.shape[1] != 8 or not np.isfinite(d).all():
            fail("(d) malformed detections")
    print(f"[12] phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return totals, outs[0]["launches"][-1]


# ----------------------------------------------------------- phase 13
WIDTH = 2  # ranks of [13](b): --mesh model=2, both on the one card, gloo
CLI_MESH = {"data": 2, "model": 2}  # [13](c): four gloo ranks on the card
WIDTH_TIMED = 5  # more steps of (b)'s honest run, timed
SEAM_COLS = 8  # columns of each level either side of the seam, [13](b)
# gates of [13](b), two ranks of 64x1328 against one process of 64x2656,
# B=1, bf16. (1) The step, after each of DP_STEPS steps (``dp_spread``):
# the losses' max relative difference, the update's median and max per
# tensor. On an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6) the
# floor (the width step in a group of one on the whole frame, the same
# sums in another order) read after steps 1 / 2 losses 0.0020 / 0.0216,
# median 0.206 / 0.255, max 1.75 / 1.99; two ranks 0.0008 / 0.0065, 0.198
# / 0.241, 2.14 / 2.13. At random weights in bf16 that spread covers the
# seam faults: the dropped halo gradient read 0.0008 / 0.0079, 0.197 /
# 0.244, 2.08 / 1.85, the unsummed counts 0.0012 / 0.0091, 0.242 / 0.261.
# So these gates only bound the step, and two
# exact gates catch the faults: (2) the targets of step 1, the ranks'
# columns put together, bit-equal to the whole frame's (the counts are
# sums of integers); (3) the width ops on the ranks' columns of
# ``op_inputs`` against the unsharded ops (``ops_on_columns``): outputs
# bit-equal, gradients within W_OP_TOL of max|ref|. On the CPU's plain
# versions in bf16 (the rehearsal) two ranks read at most 0.0100 (the
# Meta-Kernel's w1: each rank's bf16 partial rounded before the sum), the
# faults at least 0.334 (zero halos: the outputs) and 0.369 (the dropped
# halo gradient: the input gradients).
W_OP_TOL = 5e-2
W_LOSS_TOL = 5e-2
W_UPDATE_MEDIAN_TOL = 0.35
W_UPDATE_MAX_TOL = 4.0
W_FAULTS = ("halo_zeros", "halo_grad", "counts")


def seam_frame(torch, m, cfg, seed):
    """The first B=1 synthetic frame (20 boxes) from ``seed`` on that has a
    box across the seam of a WIDTH split (``seam_boxes``): -> (its seed,
    the host batch, the boxes)."""
    for s in range(seed, seed + 100):
        b = m["make_batch"](cfg, 1, seed=s, num_boxes=20)
        found = seam_boxes(torch, b, WIDTH)
        if found:
            return s, b, found
    raise SystemExit("[13] no frame with a box across the seam")


def seam_spread(run, ref, ranks=None):
    """Step 1's logits and deltas (one (B, H, Ws, K) tensor a level each)
    and the gradients of the backbone's features ((B, H, C, Ws) each) of a
    run against the reference's: max|a - b| / max|b| within SEAM_COLS
    columns of each seam (Ws / WIDTH) and over the other columns, the
    larger of the two kinds. ``ranks``: the run's ranks, whose column
    shards are put together first."""
    import torch

    near = far = 0.0
    for key, dim in (("outputs", 2), ("grads", 3)):
        got = [run[key]] if ranks is None else [o[key] for o in ranks]
        for i in range(len(ref[key])):
            a = torch.cat([g[i] for g in got], dim=dim)
            b = ref[key][i]
            mid = b.shape[dim] // WIDTH
            d = (a.double() - b.double()).abs() / b.double().abs().max()
            win = d.narrow(dim, mid - SEAM_COLS, 2 * SEAM_COLS)
            near = max(near, win.max().item())
            win.zero_()
            far = max(far, d.max().item())
    return near, far


def width_passes(spread):
    """Gate (1) of [13](b): every step's losses, update median and max."""
    return all(x["loss"] <= W_LOSS_TOL and x["median"] <= W_UPDATE_MEDIAN_TOL
               and x["max"] <= W_UPDATE_MAX_TOL for x in spread)


def targets_equal(torch, ranks_targets, want):
    """Gate (2) of [13](b): the ranks' step-1 targets, the per-level ones
    (``..._s{stride}``, (B, H, Ws, C)) put together by columns, bit-equal
    to the whole frame's. -> (equal, the keys that differ)."""
    bad = []
    for k, v in want.items():
        parts = [t[k] for t in ranks_targets]
        if k.rsplit("_s", 1)[-1].isdigit():
            same = torch.equal(torch.cat(parts, dim=2), v)
        else:
            same = all(torch.equal(p, v) for p in parts)
        if not same:
            bad.append(k)
    return not bad, bad


def width_collectives(cfg, layers, model, frames):
    """Collectives of one width step that the model implies, and how they
    add up: each BatchNorm's means forward and their cotangent backward;
    a halo exchange a 3x3 conv, deconv and (features, coordinates) the
    Meta-Kernel forward, the same backward but for the data's first conv
    and the coordinates; the per-box point counts of each frame; two loss
    normalizers a level; two flat buffers (gradients with the metrics,
    running statistics)."""
    n_bn = sum(isinstance(x, layers.BatchNormFold) for x in model.modules())
    convs = sum(isinstance(x, layers.ConvNormRelu) and x.kernel == 3
                or isinstance(x, layers.DeconvNormRelu)
                or hasattr(x, "conv2_weight") for x in model.modules())
    metas = sum(hasattr(x, "mlp0") for x in model.modules())
    fwd, bwd = convs + 2 * metas, convs + metas - 1
    levels = len(cfg.fpn_strides)
    n = 2 * n_bn + fwd + bwd + frames + 2 * levels + 2
    return n, (f"{n_bn} BatchNorms x 2 + {fwd} halo exchanges forward + "
               f"{bwd} backward + {frames} point counts + {2 * levels} loss "
               f"normalizers + 2 flat buffers = {n}")


# the width ops of [13](a) and (b): (kind, Ci, Co or Cm, H, W, stride) at
# shapes of the recipe's step, B=1: the conv at strides 1 and 2 (res1,
# res2a_unit1), the deconvs of agg1 (s=4) and agg3 (s=2), the Meta-Kernel
WIDTH_OPS = (("conv", 64, 64, 64, 2656, 1), ("conv", 64, 64, 64, 2656, 2),
             ("deconv", 128, 64, 64, 664, 4), ("deconv", 64, 64, 64, 1328, 2),
             ("meta", 64, 32, 64, 2656, 1))
HALO_FAULTS = ("halo_zeros", "halo_grad")


def op_inputs(torch, case, seed, dtype=None):
    """The whole-width inputs of a width-op case (kind, Ci, Co or Cm, H, W,
    stride), on the host, drawn from ``seed``: -> (cols: the arrays split
    by columns, with the cotangent r; whole: the weights). Activations in
    ``dtype`` (bf16 by default, as the model hands them over), f32
    weights (the deconv's in ``dtype``), an f32 cotangent."""
    kind, Ci, Co, H, W, s = case
    dtype = dtype or torch.bfloat16
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)

    if kind == "meta":
        C, Cm = Ci, Co
        cols = dict(feat=rn(1, H, C, W).to(dtype), coords=rn(1, H, 3, W),
                    r=rn(1, H, 9 * C, W))
        whole = dict(w0=rn(Cm, 3, scale=0.5), b0=rn(Cm, scale=0.1),
                     w1=rn(C, Cm, scale=0.3), b1=rn(C, scale=0.1))
        return cols, whole
    Wo = W // s if kind == "conv" else W * s
    cols = dict(x=rn(1, H, Ci, W).to(dtype), r=rn(1, H, Co, Wo))
    wt = (rn(Co, Ci, 3, 3) if kind == "conv" else
          rn(Ci, Co, 3, 2 * s)) / (3.0 * Ci ** 0.5)
    return cols, dict(weight=wt if kind == "conv" else wt.to(dtype))


def op_diff(torch, got, want):
    """A width op's (output, gradients) against the unsharded op's: ->
    ({name: bit-equal}, {name: max|a - b| / max|b|}), "out" the output."""
    same = {"out": torch.equal(got[0], want[0])}
    rels = {"out": _rel(got[0], want[0])}
    for k in want[1]:
        same[k] = torch.equal(got[1][k], want[1][k])
        rels[k] = _rel(got[1][k], want[1][k])
    return same, rels


def op_line(same, rels):
    return ", ".join(f"{k} {'bit-equal' if same[k] else f'{rels[k]:.3g}'}"
                     for k in same)


def width_ops_check(torch, dev, group, fail):
    """[13](a): the width ops in a width group of one (the exchange is the
    zero pad) against the unsharded ops at WIDTH_OPS' shapes, B=1, bf16:
    outputs and gradients. Predicted (written before the first run): the
    conv and deconv outputs and input gradients bit-equal (the kernels
    accumulate each pixel in one order, and a zero column read is the
    zero TMA fills out of bounds), the Meta-Kernel's output bit-equal
    (kernel 7, pixel by pixel); the weight gradients, f32 sums over the
    pixels in 64-pixel chunks that the extra column shifts, within
    FN_TOL but not bit-equal; the Meta-Kernel's feature gradient (the
    plain bf16 VJP, torch's own GEMMs at another width) within FN_TOL."""
    for i, case in enumerate(WIDTH_OPS):
        kind, Ci, Co, _, W, s = case
        cols, whole = op_inputs(torch, case, SEED + 13 + i)
        same, rels = op_diff(
            torch, width_op_case(torch, kind, cols, whole, s, group, dev),
            width_op_case(torch, kind, cols, whole, s, None, dev))
        print(f"[13] (a) {kind} Ci={Ci} Co={Co} W={W} s={s}, width group "
              f"of one vs unsharded: {op_line(same, rels)}")
        if kind != "meta" and not (same["out"] and same["x"]):
            fail(f"(a) {kind} s={s}: the width op in a group of one is not "
                 f"the unsharded op bit for bit")
        if not (same["out"] and max(rels.values()) <= FN_TOL):
            fail(f"(a) {kind} s={s}: width op vs unsharded {rels}")


def width_op_runs(torch, spec, ranks):
    """The width ops of the spec's ``op_cases`` (default WIDTH_OPS) on
    this rank's columns of ``op_inputs`` drawn from ``op_seed`` (in
    ``op_dtype``), honestly and under each of the spec's ``op_faults``
    (default HALO_FAULTS, ``planted``): -> {variant: [(output, gradients)
    a case]}."""
    out = {}
    for variant in ("honest",) + tuple(spec.get("op_faults", HALO_FAULTS)):
        out[variant] = []
        with planted({} if variant == "honest" else {"plant": variant}):
            for i, case in enumerate(spec.get("op_cases", WIDTH_OPS)):
                cols, whole = op_inputs(torch, case, spec["op_seed"] + i,
                                        spec.get("op_dtype"))
                cols = {k: _columns(v, ranks) for k, v in cols.items()}
                out[variant].append(width_op_case(
                    torch, case[0], cols, whole, case[5], ranks.width_group,
                    ranks.device))
    return out


def ops_on_columns(torch, ranks_ops, dev, seed):
    """[13](b)'s op gate: the WIDTH_OPS of the ranks (``width_op_runs``),
    their columns put together and their weights' gradients summed,
    against the unsharded ops on the whole inputs. Honest, the outputs are
    bit-equal and the gradients within W_OP_TOL (an edge column adds the
    neighbour's returned halo gradient in bf16, and each rank's weight
    gradient is rounded before the sum: a rounding more). -> 
    {variant: passes}, printing each case."""
    want = []
    for i, case in enumerate(WIDTH_OPS):
        cols, whole = op_inputs(torch, case, seed + i)
        want.append(width_op_case(torch, case[0], cols, whole, case[5], None,
                                  dev))
    verdict = {}
    for variant in ranks_ops[0]:
        ok = True
        for i, case in enumerate(WIDTH_OPS):
            parts = [r[variant][i] for r in ranks_ops]
            y = torch.cat([p[0] for p in parts], dim=-1)
            grads = {}
            for k in parts[0][1]:
                g = [p[1][k] for p in parts]
                grads[k] = (torch.cat(g, dim=-1) if k in ("x", "feat")
                            else sum(x.float() for x in g).to(g[0].dtype))
            same, rels = op_diff(torch, (y, grads), want[i])
            good = same["out"] and max(rels.values()) <= W_OP_TOL
            ok &= good
            print(f"[13] (b) ops, {variant}: {case[0]} Ci={case[1]} "
                  f"Co={case[2]} W={case[4]} s={case[5]} on {len(parts)} "
                  f"ranks' columns vs unsharded: {op_line(same, rels)}: "
                  f"{'pass' if good else 'reject'}")
        verdict[variant] = ok
    return verdict


def phase13(torch, m, cfg, dev, per_step):
    """Width sharding of the recipe at 64x2656 (``parallel/halo.py``, the
    width paths of ``models/``): (a) the width ops in a width group of one
    against the unsharded ops; one width step in a group of one on rank
    0's columns (64x1328) of a frame with a box across the seam, every
    launch of it through phase 5's correctness gates (its speed printed,
    not gated) and kernel 7's; the floor: the width step in a group of one
    on the whole frame against the plain step; (b) WIDTH gloo ranks on the
    one card (--mesh model=2), each 64x1328 of that frame, from [12]'s
    weights (BatchNorms perturbed), against the plain step on the frame:
    gates (1) losses and updates (``width_passes``), (2) step 1's targets
    (``targets_equal``), (3) the width ops on the ranks' columns
    (``ops_on_columns``); both ranks bit-equal, the collectives a step as
    the model implies them, three planted faults each rejected by a gate,
    each rank's launches, median and peak; (c) the train CLI under the launcher on data=2,model=2 (four
    gloo ranks on the card) from CACHE_FRAMES files: an epoch of 2 steps
    with --gspmd-width, a checkpoint, --resume --eval-every 1; the ranks
    of a data group on the same frames, all ranks bit-equal; a mesh whose
    shards are not phase-aligned refused. -> (KernelTotals of (a), the
    launches of a rank's step)."""
    pd, layers = m["pdist"], m["layers"]
    t_phase = time.perf_counter()

    def fail(msg):
        raise SystemExit(f"[13] {msg}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    H, W = cfg.pad_field  # the batch's width, a shard's twice
    init = m["RangeDet"](**cfg.model_kwargs())
    init.init_from(torch.Generator().manual_seed(SEED))
    init_sd = {k: v.clone() for k, v in init.state_dict().items()}
    perturb_bn(torch, layers, init, SEED)  # [12]'s weights of (b) and (c)
    dp_sd = {k: v.clone() for k, v in init.state_dict().items()}
    del init
    seed, batch_np, boxes = seam_frame(torch, m, cfg, SEED)
    print(f"[13] the frame of seed {seed} (the first from {SEED} with a box "
          f"across the seam at column {W // WIDTH}): boxes (frame, box, "
          f"points left, right) {boxes}")
    batch = m["batch_to_device"](batch_np, dev)
    half = m["batch_to_device"](pd.local_rows(batch_np, 0, 1, 0, WIDTH), dev)

    # (a) a width group of one
    backend = "nccl" if dev.type == "cuda" else "gloo"
    one = pd.join(str(dev), backend=backend, rank=0, world_size=1,
                  init_method=f"tcp://127.0.0.1:{free_port()}", always=True)
    try:
        width_ops_check(torch, dev, one.group, fail)

        model = m["RangeDet"](**cfg.model_kwargs())
        model.load_state_dict(init_sd)
        model = model.to(dev)
        layers.set_sync_group(model, one.group)
        layers.set_width_group(model, one.group)
        state = m["create_train_state"](model, cfg, STEPS_PER_EPOCH,
                                        seed=None)
        step = m["make_train_step"](state, cfg, one.group, one.group)
        taps_args = []
        real_taps = m["taps"].meta_kernel_taps

        def rec_taps(*args):
            taps_args.append(tuple(a.detach().clone() for a in args))
            return real_taps(*args)

        sync()
        reset_counts(m)
        with mock.patch.object(m["taps"], "meta_kernel_taps", rec_taps):
            recorded = record_train_step(step, half, m["conv3x3"], m["iou"],
                                         layers, m["meta"])
        sync()
        launches = read_counts(m)
        want = dict(per_step, meta_stats=0, meta_agg=0, meta_block_bwd=0,
                    meta_kernel_taps=meta_units(cfg))
        print(f"[13] (a) one width step in a group of one on 64x{W // WIDTH}:"
              f" launches {launches} (phase 6's step with the materialized "
              f"block: its taps from kernel 7, no fused launch)")
        if launches != want:
            fail(f"(a) launches {launches}, expected {want}")
        del model, state, step
        totals = phase5(torch, m["conv3x3"], m["iou"], layers, m["meta"],
                        m["taps"], recorded, H, dev, tag="13",
                        speed_gates=False)
        del recorded
        taps_t = totals["meta_kernel_taps"] = KernelTotals()
        for args in taps_args:
            t = check_taps(torch, m["taps"], args, "13")
            taps_t.add(1, t.ms, t.plain_ms, (t.bound_ms, t.bound_by()), None,
                       t.err)
            taps_t.f32_bound_ms += t.f32_bound_ms
        del taps_args

        # the floor: the width step in a group of one on the whole frame
        # against the plain step, the same arithmetic summed in other orders
        ref = plain_steps(torch, m, cfg, dev, dp_sd, batch, keep=True)
        w1 = plain_steps(torch, m, cfg, dev, dp_sd, batch, one.group,
                         one.group, keep=True)
    finally:
        pd.leave(one)
    init_host = {k: v.cpu() for k, v in dp_sd.items()}
    floor = dp_spread(w1["metrics"], w1["states"], ref["metrics"],
                      ref["states"], init_host)
    floor_seam = seam_spread(w1, ref)
    del w1

    # (b) two ranks over gloo on the card, --mesh model=2
    runs = [dict(name="honest", timed=WIDTH_TIMED)] + [
        dict(name=f, plant=f) for f in W_FAULTS]
    spec = dict(cfg=cfg, state=init_host, batch=batch_np, steps=DP_STEPS,
                device=str(dev), backend="gloo", mode="sync",
                mesh={"data": 1, "model": WIDTH}, runs=runs,
                keep_step1=True, op_seed=SEED + 31)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = wait_ranks(start_ranks(spec, WIDTH, tmp, "width"))
        t1 = time.perf_counter()
    print(f"[13] (b) {WIDTH} ranks over gloo on {spec['device']}, "
          f"--mesh model={WIDTH}, 64x{W // WIDTH} each: the honest run and "
          f"the {len(W_FAULTS)} faults' in {t1 - t0:.1f} s")
    n_coll, how = width_collectives(cfg, layers,
                                    m["RangeDet"](**cfg.model_kwargs()), 1)
    print(f"[13] (b) expected collectives a step: {how}")
    rank_launches = outs[0]["honest"]["launches"][-1]
    for r, o in enumerate(outs):
        h = o["honest"]
        print(f"[13] (b) rank {r}: launches a step {h['launches'][-1]}, "
              f"collectives a step {h['collectives']}, step median "
              f"{h.get('step_ms', 'not measured')} ms over {WIDTH_TIMED} "
              f"steps, peak memory {h.get('peak_gib', 'not measured')} GiB")
        if h["launches"] != [want] * DP_STEPS:
            fail(f"(b) rank {r} launches {h['launches']}, (a)'s {want}")
        if h["collectives"] != [n_coll] * DP_STEPS:
            fail(f"(b) rank {r} collectives {h['collectives']}, expected "
                 f"{n_coll}")
    for name in ("honest",) + W_FAULTS:
        a, b = (o[name] for o in outs)
        same = a["metrics"] == b["metrics"] and all(
            torch.equal(x[k], y[k]) for x, y in zip(a["states"], b["states"])
            for k in x)
        print(f"[13] (b) {name}: both ranks' metrics and states bit-equal: "
              f"{same}")
        if not same:
            fail(f"(b) {name}: the ranks differ")
    stat = {"floor (width step, group of one, whole frame)": (
        floor, floor_seam)}
    for name in ("honest",) + W_FAULTS:
        o = outs[0][name]
        stat[name] = (dp_spread(o["metrics"], o["states"], ref["metrics"],
                                ref["states"], init_host),
                      seam_spread(None, ref, [x[name] for x in outs]))
    step_ok = {}
    for name, (sp, (near, far)) in stat.items():
        step_ok[name] = width_passes(sp)
        print(f"[13] (b) {name} vs one process on 64x{W} (total_loss "
              + " ".join(f"{x['total_loss']:.6f}" for x in ref["metrics"])
              + f"): {dp_line(sp)}; step 1's outputs and feature gradients "
              f"max|a-b|/max|b| within {SEAM_COLS} columns of the seam "
              f"{near:.4g}, elsewhere {far:.4g} (printed); gate (1), every "
              f"step: losses <= {W_LOSS_TOL}, update median <= "
              f"{W_UPDATE_MEDIAN_TOL}, max <= {W_UPDATE_MAX_TOL}: "
              f"{'pass' if step_ok[name] else 'reject'}")
    want_t = {k: v.cpu() for k, v in m["build_train_targets"](
        batch, cfg).items()}
    targets_ok = {}
    for name in ("honest",) + W_FAULTS:
        targets_ok[name], bad = targets_equal(
            torch, [o[name]["targets"] for o in outs], want_t)
        print(f"[13] (b) {name}: gate (2), step 1's targets on the ranks' "
              f"columns bit-equal to the whole frame's: "
              f"{targets_ok[name]}{f' (differ: {bad})' if bad else ''}")
    ops_ok = ops_on_columns(torch, [o["ops"] for o in outs], dev, spec[
        "op_seed"])
    verdict = {name: step_ok[name] and targets_ok[name] and ops_ok[
        "honest" if name in ("honest", "counts") else name]
        for name in ("honest",) + W_FAULTS}
    print(f"[13] (b) gates (1)-(3) pass: " + ", ".join(
        f"{k} {v}" for k, v in verdict.items()))
    if not (verdict["honest"] and step_ok[next(iter(stat))]):
        fail("(b) two ranks (or the floor) vs one process outside the gates")
    passed = [f for f in W_FAULTS if verdict[f]]
    if passed:
        fail(f"(b) the gates pass the planted faults {passed}")
    del outs, ref

    # (c) the train CLI under the launcher, data=2,model=2
    phase13_cli(torch, m, cfg, dev, fail)
    print(f"[13] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return totals, rank_launches


def phase13_cli(torch, m, cfg, dev, fail):
    """[13](c): ``tools.train`` on data=2,model=2, four gloo ranks on the
    card under ``python -m torch.distributed.run`` (each rank
    ``cli_rank_main``), from CACHE_FRAMES files: an epoch of 2 steps with
    --gspmd-width into checkpoint 0, then --epochs 2 --resume --eval-every
    1; and a mesh whose shards are not phase-aligned refused."""
    import numpy as np

    H, W = cfg.feat_size
    world = CLI_MESH["data"] * CLI_MESH["model"]
    mesh = ",".join(f"{k}={v}" for k, v in CLI_MESH.items())
    # every rank on the one card (cuda:LOCAL_RANK would name four)
    card = (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
            else "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        data, exp = os.path.join(tmp, "data"), os.path.join(tmp, "exp")
        m["write_waymo_files"](data, CACHE_FRAMES, H=H, W=W, seed=SEED + 3,
                               image_set="training", num_boxes=20)
        m["write_waymo_files"](data, VAL_FRAMES, H=H, W=W, seed=SEED + 4,
                               image_set="validation", num_boxes=20)
        train = ["--config", RECIPE, "--data-root", data, "--sampling-rate",
                 "1", "--batch", "1", "--num-workers", "2",
                 "--steps-per-epoch", "2", "--experiment-dir", exp,
                 "--device", card, "--mesh", mesh]
        t0 = time.perf_counter()
        first, log1 = launch_cli_ranks(
            tmp, "first", world, train + ["--epochs", "1", "--gspmd-width"])
        t1 = time.perf_counter()
        second, log2 = launch_cli_ranks(
            tmp, "second", world, train + ["--epochs", "2", "--resume",
                                           "--eval-every", "1",
                                           "--eval-frames", "2"])
        t2 = time.perf_counter()
    print(f"[13] (c) tools.train --mesh {mesh} under torch.distributed.run "
          f"--nproc_per_node {world} (gloo, one card): an epoch of 2 steps "
          f"with --gspmd-width {t1 - t0:.1f} s, --resume --eval-every 1 "
          f"{t2 - t1:.1f} s")
    # the epoch's 2 batches and the PREFETCH_DEPTH - 1 the loop puts (and
    # so shares) ahead of its last step
    n_shared = 2 + m["train_cli"].PREFETCH_DEPTH - 1
    for name, runs, log in (("first", first, log1), ("resumed", second,
                                                       log2)):
        for o in runs:
            d, mm = divmod(o["rank"], CLI_MESH["model"])
            peer = runs[d * CLI_MESH["model"]]
            frames = [u for u in o["mapped"] if "/training/" in u]
            print(f"[13] (c) {name} rank {o['rank']} (d, m) = ({d}, {mm}): "
                  f"steps {[h['step'] for h in o['hist']]}, total_loss "
                  + " ".join(f"{h['total_loss']:.6f}" for h in o["hist"])
                  + f"; training frames mapped {len(frames)}, batches "
                  f"received {len(o['shared'])} (want {n_shared}), the same "
                  f"as rank "
                  f"{peer['rank']}'s: {o['shared'] == peer['shared']}; "
                  f"checkpoints saved {o['saved']}")
            if o["shared"] != peer["shared"] or \
                    len(o["shared"]) != n_shared:
                fail(f"(c) {name}: rank {o['rank']} trained on other frames "
                     f"than rank {peer['rank']}")
            if mm and frames:
                fail(f"(c) {name}: rank {o['rank']} (m = {mm}) loaded frames")
        a = runs[0]
        if runs[0]["shared"] == runs[CLI_MESH["model"]]["shared"]:
            fail(f"(c) {name}: data indices 0 and 1 trained on one batch")
        same = all(all(torch.equal(v, o["state"][k])
                       for k, v in a["state"].items()) for o in runs)
        print(f"[13] (c) {name}: all {world} ranks' states bit-equal: {same}")
        if not same:
            fail(f"(c) {name}: the ranks' states differ")
    gspmd = "--gspmd-width: no auto-partitioner" in log1
    resumed = "resumed from epoch 0" in log2
    val = second[0]["val"]
    print(f"[13] (c) --gspmd-width logged its line: {gspmd}; resumed from "
          f"epoch 0: {resumed}; step count {second[0]['step']}; checkpoints "
          f"saved {first[0]['saved']} + {second[0]['saved']}; validation "
          f"(every rank, whole frames) {val}")
    if not (gspmd and resumed and second[0]["step"] == 4
            and first[0]["saved"] == [0] and second[0]["saved"] == [1]):
        fail(f"(c) the CLI's runs:\n{log1[-2000:]}\n{log2[-2000:]}")
    if sorted(val) != [1] or not all(
            np.isfinite(x) for res in val[1].values() for x in res.values()):
        fail(f"(c) validation {val}")
    args = m["train_cli"].parse_args(["--config", RECIPE, "--mesh",
                                      "model=4"])
    try:
        m["train_cli"].check_jax_flags(args, cfg, 4)
    except SystemExit as e:
        print(f"[13] (c) --mesh model=4 over 4 processes refused: {e}")
        if not ("phase-aligned" in str(e) or "halo" in str(e)):
            fail(f"(c) refused for another reason: {e}")
    else:
        fail("(c) --mesh model=4 (shards of 664 columns) was not refused")


def launch_cli_ranks(tmp, name, world, argv):
    """``tools.train``'s main with ``argv`` on ``world`` ranks under
    ``python -m torch.distributed.run --standalone``, each rank
    ``cli_rank_main``. -> (each rank's record by rank, the launcher's
    output)."""
    import torch

    out = os.path.join(tmp, f"{name}_rank")
    repo = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(world), os.path.abspath(__file__),
         "--cli-rank", out, "train"] + argv, cwd=repo, capture_output=True,
        text=True,
        timeout=RANK_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"))
    log = p.stdout + p.stderr
    if p.returncode:
        raise SystemExit(f"[13] tools.train {' '.join(argv)}: exit "
                         f"{p.returncode}\n{log[-4000:]}")
    return [torch.load(f"{out}{r}.pt", weights_only=False)
            for r in range(world)], log


def cli_rank_main(out, cli, argv):
    """One rank of a CLI (``cli``: "train" or "test") under a launcher
    (``launch_cli_ranks``, the CPU tests' ``torch_dp.cli_ranks``): its
    main on ``argv``. For "train" it records the roidb records the loader
    maps (their ``pc_url``), the checkpoints saved and a hash of each whole
    batch the width group shares (``dist.share_batch``), and saves them
    with the history, the state, the step count and the validations to
    ``out<RANK>.pt``; for "test", the pickle's path (None off rank 0)."""
    import hashlib

    import numpy as np
    import torch

    from rangedet_tpu_torch.data import waymo
    from rangedet_tpu_torch.parallel import dist as pd
    from rangedet_tpu_torch.tools import test, train
    from rangedet_tpu_torch.train import checkpoint

    rank = int(os.environ.get("RANK", 0))
    if cli == "test":
        torch.save(dict(path=test.main(argv)), f"{out}{rank}.pt")
        return
    mapped, saved, shared = [], [], []
    real_map, real_save = waymo.record_to_inputs, checkpoint.save_checkpoint
    real_share = pd.share_batch

    def mapping(rec, *a, **k):
        mapped.append(rec["pc_url"])
        return real_map(rec, *a, **k)

    def saving(state, cfg, epoch):
        saved.append(epoch)
        return real_save(state, cfg, epoch)

    def sharing(batch, ranks):
        whole = real_share(batch, ranks)
        h = hashlib.sha1()
        for k in sorted(whole):
            h.update(np.ascontiguousarray(whole[k]).tobytes())
        shared.append(h.hexdigest())
        return whole

    with mock.patch.object(waymo, "record_to_inputs", mapping), \
            mock.patch.object(checkpoint, "save_checkpoint", saving), \
            mock.patch.object(pd, "share_batch", sharing):
        hist, state, val = train.main(argv)
    torch.save(dict(rank=rank, hist=hist, step=state.step, val=val,
                    state={k: v.detach().cpu() for k, v in
                           state.model.state_dict().items()},
                    mapped=mapped, saved=saved, shared=shared),
               f"{out}{rank}.pt")


# ----------------------------------------------------------- phase 14
BUILD_SEGMENTS = 2  # training segments of [14](a); one validation segment
BUILD_FRAMES = 4  # frames a segment
BUILD_BOXES = 8  # vehicles a frame
BUILD_YAW = 0.05  # rad: the lidar extrinsic's yaw, a few degrees
BUILD_MOUNT = (1.4, 0.0, 2.2)  # m: the roof mount, forward and up
# pc_vehicle_frame of the card's build against the CPU's, in f32 ulps of
# the point's largest coordinate (cos / sin / the 3x3 product differ)
BUILD_PC_ULPS = 4
BOX_TOL = 0.01  # m: a rendered pixel's point from its box, vehicle frame
KITTI_SCANS = 4
KITTI_POINTS = 120_000
KITTI_BOXES = 3  # cars a scan, KITTI_BOX_POINTS returns inside each
KITTI_BOX_POINTS = 400
KITTI_W = 2048
# rad: a point this near a row or a column boundary (of elevation error,
# of azimuth) may fall on the other side on the card (atan2's ulps)
EDGE_BAND = 1e-4
FACE_BAND = 1e-5  # m: a point this near a box face may flip its count


def lidar_extrinsic(theta, mount):
    """4x4 f32 lidar-to-vehicle transform: a yaw ``theta`` about z and the
    translation ``mount``."""
    import numpy as np

    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s, 0, mount[0]], [s, c, 0, mount[1]],
                     [0, 0, 1, mount[2]], [0, 0, 0, 1]], np.float32)


def waymo_frames(torch, seed, n, H, W, theta, mount, seg, dev,
                 num_boxes=BUILD_BOXES, boxes=None):
    """``n`` duck-typed Waymo Frames of segment ``seg`` (SimpleNamespace
    with the proto's attribute surface, as tests/test_waymo_pipeline.py
    builds them) from a lidar of extrinsic yaw ``theta`` mounted at
    ``mount``: ``num_boxes`` vehicles placed in the vehicle frame (or the
    (K, 7) vehicle-frame csa ``boxes``), moved into the sensor frame and
    raytraced there on ``dev`` (``synthetic_device.raytrace_boxes``) in
    Waymo's column convention (range_image_utils.compute_range_image_polar:
    column i looks along the vehicle-frame azimuth pi - (i + 1/2) 2 pi / W,
    so along that less ``theta`` in the sensor frame), before a background
    wall, 5% of the pixels without a return. -> (frames,
    parse_range_images, owners: per frame the (H, W) box each pixel's
    return hit, -1 for none, and the vehicle-frame csa (K, 7))."""
    from types import SimpleNamespace as NS

    import numpy as np

    from rangedet_tpu_torch.data.synthetic_device import (
        VEHICLE_DIMS,
        inclinations,
        raytrace_boxes,
    )

    rng = np.random.RandomState(seed)
    ext = lidar_extrinsic(theta, mount)
    R, t = ext[:3, :3].astype(np.float64), ext[:3, 3].astype(np.float64)
    incl = inclinations(H)  # top row first; the proto stores bottom-up
    az = math.pi - (np.arange(W) + 0.5) * (2 * math.pi / W) - theta
    incl_t = torch.from_numpy(incl).to(dev)
    az_t = torch.from_numpy(az.astype(np.float32)).to(dev)
    calib = NS(name=1, beam_inclinations=incl[::-1].tolist(),
               extrinsic=NS(transform=ext.ravel().tolist()))
    frames, images, owners = [], [], []
    for i in range(n):
        csa = boxes
        if csa is None:
            placed = []
            while len(placed) < num_boxes:
                r, a = rng.uniform(7.0, 40.0), rng.uniform(-math.pi, math.pi)
                cx, cy = t[0] + r * math.cos(a), t[1] + r * math.sin(a)
                if any(math.hypot(cx - p[0], cy - p[1]) < 7.0
                       for p in placed):
                    continue
                lwh = [rng.uniform(*d) for d in VEHICLE_DIMS]
                placed.append([cx, cy, lwh[2] / 2, *lwh,
                               rng.uniform(-math.pi / 2, math.pi / 2)])
            csa = np.array(placed)
        csa = np.asarray(csa, np.float64).reshape(-1, 7)
        sensor = csa.copy()
        sensor[:, :3] = (csa[:, :3] - t) @ R  # R^T (c - t), row-wise
        sensor[:, 6] = csa[:, 6] - theta
        hit, owner = raytrace_boxes(
            torch.from_numpy(sensor.astype(np.float32)).to(dev), incl_t,
            az_t)
        hit, owner = hit.cpu().numpy(), owner.cpu().numpy()
        bg = (rng.uniform(25.0, 75.0, (H, 1))
              + rng.uniform(-2.0, 2.0, (H, W))).astype(np.float32)
        obj = np.isfinite(hit) & (hit < bg)
        hole = rng.uniform(size=(H, W)) < 0.05
        rng_img = np.where(hole, -1.0, np.where(obj, hit, bg))
        owner = np.where(obj & ~hole, owner, -1)
        ri = np.stack([rng_img, rng.uniform(0, 1, (H, W)),
                       rng.uniform(0, 0.3, (H, W)), -np.ones((H, W))],
                      -1).astype(np.float32)
        counts = np.bincount(owner[owner >= 0], minlength=len(csa))
        labels = [NS(box=NS(center_x=b[0], center_y=b[1], center_z=b[2],
                            length=b[3], width=b[4], height=b[5],
                            heading=b[6]),
                     type=1, num_lidar_points_in_box=int(counts[k]),
                     metadata=NS(speed_x=float(rng.uniform(-5, 5)),
                                 speed_y=float(rng.uniform(-5, 5)),
                                 accel_x=0.0, accel_y=0.0))
                  for k, b in enumerate(csa.astype(np.float32).tolist())]
        frames.append(NS(context=NS(name=seg, laser_calibrations=[calib]),
                         laser_labels=labels, timestamp_micros=1000 * i))
        images.append(ri)
        owners.append((owner, csa.astype(np.float32)))

    def parse(frame):
        ri = images[frames.index(frame)]
        return {1: [NS(data=ri.ravel(), shape=NS(dims=list(ri.shape)))]}

    return frames, parse, owners


def box_excess(pc, owner, csa):
    """The largest distance (m) from a pixel's point pc (H, W, 3) to the box
    ``owner`` says its return hit (csa (K, 7), the same frame), 0 inside,
    and the number of such pixels."""
    import numpy as np

    sel = owner >= 0
    p = pc[sel].astype(np.float64)
    b = csa[owner[sel]].astype(np.float64)
    d = p - b[:, :3]
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    local = np.stack([d[:, 0] * c + d[:, 1] * s,
                      -d[:, 0] * s + d[:, 1] * c, d[:, 2]], 1)
    out = np.maximum(np.abs(local) - b[:, 3:6] / 2, 0.0)
    return float(np.sqrt((out ** 2).sum(1)).max(initial=0.0)), int(sel.sum())


KITTI_CALIB = ("P2: 7.2e2 0 6e2 0 0 7.2e2 1.8e2 0 0 0 1 0\n"
               "R0_rect: 1 0 0 0 1 0 0 0 1\n"
               "Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0\n")


def kitti_root(root, seed, n_scans, n_points, width=KITTI_W):
    """A KITTI object root (velodyne/, calib/, label_2/) of ``n_scans``
    synthesized scans of ``n_points`` returns each: returns on the
    HDL-64E's lasers at ranges of 3-70 m, and KITTI_BOXES cars a scan (a
    label row each, KITTI_BOX_POINTS returns inside each); the calib maps
    lidar axes to camera axes (R0 = I). -> the scans (N, 4) and their
    lidar-frame csa (KITTI_BOXES, 7)."""
    import numpy as np

    from rangedet_tpu_torch.data.kitti import KITTI_INCLINATION

    rng = np.random.RandomState(seed)
    for d in ("velodyne", "calib", "label_2"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    scans, boxes = [], []
    for i in range(n_scans):
        n_bg = n_points - KITTI_BOXES * KITTI_BOX_POINTS
        azi = rng.uniform(-np.pi, np.pi, n_bg)
        incl = rng.choice(KITTI_INCLINATION, n_bg) + rng.normal(0, 1e-3, n_bg)
        r = rng.uniform(3, 70, n_bg)
        bg = np.stack([r * np.cos(incl) * np.cos(azi),
                       r * np.cos(incl) * np.sin(azi),
                       r * np.sin(incl) + 0.16, rng.uniform(0, 1, n_bg)], 1)
        csa, rows, inside = [], [], []
        for k in range(KITTI_BOXES):
            a = (k - 1) * 0.8 + rng.uniform(-0.2, 0.2)
            rr = rng.uniform(8, 30)
            l, w, h = rng.uniform(3.6, 4.8), rng.uniform(1.6, 1.9), \
                rng.uniform(1.4, 1.7)
            b = [rr * np.cos(a), rr * np.sin(a), -1.73 + h / 2, l, w, h,
                 rng.uniform(-np.pi / 2, np.pi / 2)]
            csa.append(b)
            u = rng.uniform(-0.5, 0.5, (KITTI_BOX_POINTS, 3)) * [l, w, h]
            c, s = np.cos(b[6]), np.sin(b[6])
            inside.append(np.stack([b[0] + u[:, 0] * c - u[:, 1] * s,
                                    b[1] + u[:, 0] * s + u[:, 1] * c,
                                    b[2] + u[:, 2],
                                    rng.uniform(0, 1, KITTI_BOX_POINTS)], 1))
            # camera rect frame, bottom centre: x = -y, y = -z, z = x
            rows.append(f"Car 0 0 0 0 0 50 50 {h} {w} {l} {-b[1]} "
                        f"{-(b[2] - h / 2)} {b[0]} {-b[6] - np.pi / 2}")
        rows.append("DontCare -1 -1 -10 0 0 10 10 -1 -1 -1 -1000 -1000 "
                    "-1000 -10")
        scan = np.concatenate([bg] + inside).astype(np.float32)
        scan = scan[rng.permutation(len(scan))]
        name = f"{i:06d}"
        scan.tofile(os.path.join(root, "velodyne", f"{name}.bin"))
        with open(os.path.join(root, "calib", f"{name}.txt"), "w") as f:
            f.write(KITTI_CALIB)
        with open(os.path.join(root, "label_2", f"{name}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        scans.append(scan)
        boxes.append(np.array(csa, np.float32))
    return scans, boxes


def edge_points(torch, pc, width, band=EDGE_BAND):
    """(N,) bool: the points of ``pc`` (N, 3+) whose row or column decision
    lies within ``band`` of a boundary (CPU float32, as the builder)."""
    from rangedet_tpu_torch.data import kitti

    p = torch.from_numpy(pc)
    _, _, col_f = kitti.pixel_indices(p, width)
    to_col = (col_f - torch.floor(col_f) - 0.5).abs() * (2 * math.pi / width)
    elev = torch.atan2(torch.from_numpy(kitti.KITTI_LASER_HEIGHT)[None, :]
                       - p[:, 2:3], kitti._norm(p[:, :2])[:, None])
    err = torch.abs(torch.from_numpy(kitti.KITTI_INCLINATION)[None, :]
                    - elev).sort(dim=1).values
    return ((to_col < band) | (err[:, 1] - err[:, 0] < band)).numpy()


def face_points(pc, csa, band=FACE_BAND):
    """(M, N) bool: point n lies within ``band`` m of a face plane of box m
    (float64), where its count may flip."""
    import numpy as np

    d = pc[None, :, :3].astype(np.float64) - csa[:, None, :3]
    c, s = np.cos(csa[:, 6:7]), np.sin(csa[:, 6:7])
    local = np.stack([d[..., 0] * c + d[..., 1] * s,
                      -d[..., 0] * s + d[..., 1] * c, d[..., 2]], -1)
    gap = np.abs(np.abs(local) - csa[:, None, 3:6] / 2)
    return (gap < band).any(-1)


def overlap_check(trace, sizes):
    """The torch.profiler trace of a train CLI run: -> (the step's stream
    (the one with the most kernel time), the batch copies (host-to-device
    copies of one of the byte ``sizes`` of the batches' tensors of 1 MB
    or more) on each stream, the copies that overlap a kernel on the
    step's stream)."""
    kernels, copies = {}, []
    for e in trace:
        if e.get("cat") == "kernel":
            s = e.get("args", {}).get("stream")
            kernels.setdefault(s, []).append((e["ts"], e["ts"] + e["dur"]))
        elif (e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")
              and e.get("args", {}).get("bytes") in sizes):
            copies.append((e["args"].get("stream"), e["ts"],
                           e["ts"] + e["dur"]))
    if not kernels:
        return None, {}, 0
    step = max(kernels, key=lambda s: sum(b - a for a, b in kernels[s]))
    spans = sorted(kernels[step])
    by_stream = {}
    n_over = 0
    for s, a, b in copies:
        by_stream[s] = by_stream.get(s, 0) + 1
        if any(ka < b and a < kb for ka, kb in spans):
            n_over += 1
    return step, by_stream, n_over


def phase14(torch, m, cfg, dev, per_step):
    """The user's chain from raw frames on ``RECIPE``: (a) Waymo frames
    through the port's builder on the card and on the CPU, then train,
    resume, test, export and AP on the built files; (b) KITTI scans
    through the port's KITTI CLI on the card and the CPU, one train step
    and one eval step on the records; (c) the loader's device prefetch:
    no race, and its copies overlap the steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rangedet_tpu_torch.data import kitti
    from rangedet_tpu_torch.data import waymo_builder as wb
    from rangedet_tpu_torch.tools import create_range_image_in_kitti as kcli

    train_cli = m["train_cli"]
    cpu = torch.device("cpu")

    def fail(msg):
        raise SystemExit(f"[14] {msg}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    H, W = cfg.feat_size
    # an eval forward: the conv kernel's launches and the taps kernel's
    n_fwd, n_meta = conv_launches(cfg)[0], meta_units(cfg)
    per_frame = dict.fromkeys(per_step, 0)
    per_frame.update(fwd=n_fwd, meta_kernel_taps=n_meta)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # ------------------------------------------------ (a) the builder
        npz_s = [0.0]
        geometry_ms = {"card": [], "cpu": []}
        building = ["card"]
        real_write, real_geometry = wb.write_npz, wb.frame_geometry

        def timed_write(path, **arrays):
            t0 = time.perf_counter()
            real_write(path, **arrays)
            npz_s[0] += time.perf_counter() - t0

        def timed_geometry(ri, calib, device):
            t0 = time.perf_counter()
            out = real_geometry(ri, calib, device)  # numpy: synchronized
            geometry_ms[building[0]].append(1e3 * (time.perf_counter() - t0))
            return out

        spent = {"card": [0.0, 0.0], "cpu": [0.0, 0.0]}  # build s, npz s
        worst_ulps = worst_box = 0.0
        n_px = n_frames = 0
        segs = [(f"seg_train_{s}", "training", SEED + 140 + s)
                for s in range(BUILD_SEGMENTS)] + [
            ("seg_val", "validation", SEED + 149)]
        for seg, split, seed in segs:
            frames, parse, owners = waymo_frames(
                torch, seed, BUILD_FRAMES, H, W, BUILD_YAW, BUILD_MOUNT, seg,
                dev)
            built = {}
            for where, d in (("card", dev), ("cpu", cpu)):
                npz_s[0], building[0] = 0.0, where
                sync()
                t0 = time.perf_counter()
                with mock.patch.object(wb, "write_npz", timed_write), \
                        mock.patch.object(wb, "frame_geometry",
                                          timed_geometry):
                    built[where] = wb.build_segment_from_frames(
                        iter(frames), parse, os.path.join(tmp, where), split,
                        seg, device=d)
                spent[where][0] += time.perf_counter() - t0
                spent[where][1] += npz_s[0]
            for i, (a, b) in enumerate(zip(built["card"], built["cpu"])):
                na, nb = np.load(a["pc_url"]), np.load(b["pc_url"])
                for k in ("range_image", "inclination", "azimuth"):
                    if not np.array_equal(na[k], nb[k]):
                        fail(f"{seg} frame {i}: {k} differs, card vs CPU")
                for k in a:
                    same = (a[k] == b[k] if k in ("pc_url", "rec_id",
                                                  "meta_info")
                            else np.array_equal(a[k], b[k]))
                    if k != "pc_url" and not same:
                        fail(f"{seg} frame {i}: roidb {k} differs")
                pa, pb = na["pc_vehicle_frame"], nb["pc_vehicle_frame"]
                scale = np.spacing(np.abs(pb).max(-1, keepdims=True))
                worst_ulps = max(worst_ulps,
                                 float((np.abs(pa - pb) / scale).max()))
                owner, csa = owners[i]
                if not np.array_equal(a["gt_bbox_csa"], csa):
                    fail(f"{seg} frame {i}: roidb boxes are not the labels")
                ex, n = box_excess(pa, owner, csa)
                worst_box, n_px = max(worst_box, ex), n_px + n
                n_frames += 1
        print(f"[14] (a) the Waymo builder on {n_frames} raytraced frames of "
              f"{H}x{W} ({BUILD_SEGMENTS} training segments and one "
              f"validation segment of {BUILD_FRAMES}; lidar yaw {BUILD_YAW} "
              f"rad, mount {BUILD_MOUNT} m): range image, inclination, "
              f"azimuth and roidb card = CPU; pc_vehicle_frame card vs CPU "
              f"at most {worst_ulps:.3g} ulps (gate {BUILD_PC_ULPS}); "
              f"{n_px} rendered box pixels back in the vehicle frame at "
              f"most {worst_box * 100:.4f} cm from their box (gate "
              f"{BOX_TOL * 100:g} cm)")
        if worst_ulps > BUILD_PC_ULPS:
            fail(f"pc_vehicle_frame {worst_ulps} ulps off the CPU's")
        if not n_px or worst_box > BOX_TOL:
            fail(f"a rendered pixel lands {worst_box} m from its box")
        ms = {w: [1e3 * (s - z) / n_frames, 1e3 * z / n_frames]
              for w, (s, z) in spent.items()}
        geo = {w: statistics.median(v) for w, v in geometry_ms.items()}
        print(f"[14] (a) builder ms a {H}x{W} frame (mean of {n_frames}): "
              f"card {ms['card'][0]:.2f} + npz write {ms['card'][1]:.2f}; "
              f"CPU {ms['cpu'][0]:.2f} + npz write {ms['cpu'][1]:.2f}; of "
              f"which the geometry (frame_geometry, median): card "
              f"{geo['card']:.2f} (first frame {geometry_ms['card'][0]:.2f}),"
              f" CPU {geo['cpu']:.2f}")

        # ------------------------------------------ (a) the chain, (c)
        data, exp = os.path.join(tmp, "card"), os.path.join(tmp, "exp")
        argv = ["--config", RECIPE, "--data-root", data, "--sampling-rate",
                "1", "--batch", "2", "--num-workers", "2",
                "--experiment-dir", exp, "--device", dev.type]
        n_steps = BUILD_SEGMENTS * BUILD_FRAMES // 2
        puts = []
        real_put = m["train_step"].batch_to_device

        def recorded_put(batch, device):
            puts.append({k: np.array(v, copy=True) for k, v in
                         batch.items()})
            return real_put(batch, device)

        def run(*extra, recording=False):
            out = io.StringIO()
            sync()
            reset_counts(m)
            with contextlib.ExitStack() as st:
                st.enter_context(contextlib.redirect_stdout(out))
                if recording:
                    st.enter_context(mock.patch.object(
                        m["train_step"], "batch_to_device", recorded_put))
                hist, state, val = train_cli.main(argv + list(extra))
            sync()
            return hist, state, val, out.getvalue(), read_counts(m)

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            hist0, _, _, text0, got0 = run("--epochs", "1", recording=True)
        trace_path = os.path.join(tmp, "prefetch.json")
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            trace = json.load(f)["traceEvents"]
        sizes = {v.nbytes for b in puts for v in b.values()
                 if v.nbytes >= 2 ** 20}
        step_stream, copies, n_over = overlap_check(trace, sizes)
        del trace, prof
        want = {k: n_steps * v for k, v in per_step.items()}
        if len(hist0) != n_steps or got0 != want:
            fail(f"tools.train --epochs 1: {len(hist0)} steps, launches "
                 f"{got0}, expected {n_steps} steps and {want}")
        hist1, state, val, text1, got1 = run(
            "--epochs", "2", "--resume", "--eval-every", "1",
            "--eval-frames", str(BUILD_FRAMES))
        resumed = "resumed from epoch 0" in text1
        steps = [h["step"] for h in hist0 + hist1]
        vals = [v for mt in val.get(1, {}).values() for v in mt.values()]
        if not resumed or steps != list(range(2 * n_steps)) or \
                state.step != 2 * n_steps:
            fail(f"tools.train --resume: resumed {resumed}, steps {steps}")
        if list(val) != [1] or not vals or not all(map(math.isfinite,
                                                       vals)):
            fail(f"validation {val}")
        params = [ln.split("INFO ")[-1] for ln in text0.splitlines()
                  if "params: " in ln]
        print(f"[14] (a) tools.train --data-root <built> --epochs 1 "
              f"({n_steps} steps of B=2, {params[0] if params else 'no params line'}"
              f"), then --epochs 2 --resume --eval-every 1: resumed from "
              f"epoch 0 at step {hist1[0]['step']}, validation on "
              f"{BUILD_FRAMES} frames {json.dumps(val[1])}; launches of "
              f"epoch 0's steps {n_steps} x [6]'s per step: {got0 == want}; "
              f"total_loss "
              + " ".join(f"{h['total_loss']:.4f}" for h in hist0 + hist1))
        if not params:
            fail("no params line in the log")
        steady = hist0[1:] + hist1[1:]
        print(f"[14] (c) tools.train per step at {H}x{W}, B=2, from the "
              f"built files (device prefetch depth "
              f"{train_cli.PREFETCH_DEPTH}): data_ms "
              + " ".join(f"{h['data_ms']:.2f}" for h in hist0 + hist1)
              + "; step_ms "
              + " ".join(f"{h['step_ms']:.2f}" for h in hist0 + hist1)
              + f"; medians without each epoch's first step: data_ms "
              f"{statistics.median(h['data_ms'] for h in steady):.2f}, "
              f"step_ms "
              f"{statistics.median(h['step_ms'] for h in steady):.2f}")

        # no race: the same steps on the same batches, copied synchronously
        args = train_cli.parse_args(argv + ["--epochs", "1"])
        scfg = train_cli.apply_overrides(
            m["load_config"](RECIPE, is_train=True), args, 1)
        model = m["RangeDet"](**scfg.model_kwargs())
        model.init_from(torch.Generator().manual_seed(args.seed))
        ref = m["create_train_state"](model.to(dev), scfg, n_steps,
                                      seed=None)
        ref_step = m["train_step"].build_train_step_fn(ref, scfg)
        if len(puts) != n_steps:
            fail(f"{len(puts)} batches put for {n_steps} steps")
        same = []
        for host, h in zip(puts, hist0):
            b = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
            sync()
            mt = ref_step(b)
            same.append(all(float(v) == h[k] for k, v in mt.items()))
        del ref, ref_step, model
        print(f"[14] (c) no race: epoch 0's {n_steps} steps' metrics from "
              f"the CLI (put on a side stream by the prefetch thread) "
              f"bit-equal to the same "
              f"steps on the same batches after a synchronous copy: {same}")
        if not all(same):
            fail("the prefetched steps differ from synchronous copies")
        print(f"[14] (c) overlap: under torch.profiler, batch copies "
              f"(host-to-device, a batch tensor's size of >= 1 MB) by "
              f"stream {copies}, the step's stream {step_stream}; {n_over} "
              f"of them overlap a kernel on the step's stream")
        if dev.type == "cuda" and (not copies or step_stream in copies
                                   or not n_over):
            fail("the batch copies do not run beside the steps")

        # test -> export -> AP
        reset_counts(m)
        pred = os.path.join(tmp, "pred.pkl")
        with contextlib.redirect_stdout(io.StringIO()):
            path = m["test_cli"].main([
                "--config", RECIPE, "--data-root", data, "--image-set",
                "validation", "--batch", "2", "--experiment-dir", exp,
                "--epoch", "1", "--device", dev.type, "--output", pred])
        sync()
        tgot = read_counts(m)
        twant = {k: BUILD_FRAMES // 2 * v for k, v in per_frame.items()}
        with open(path, "rb") as f:
            anno, outputs = pickle.load(f), pickle.load(f)
        if len(outputs) != BUILD_FRAMES or sorted(anno) != sorted(outputs):
            fail(f"tools.test: predictions for {sorted(outputs)}")
        if tgot != twant:
            fail(f"tools.test: launches {tgot}, expected {twant}")
        n_det = sum(len(o["det_xyzlwhyaws"]["veh"]) for o in outputs.values())
        with contextlib.redirect_stdout(io.StringIO()):
            n_out = m["bin_cli"].main(["--pred", path, "--out",
                                       os.path.join(tmp, "pred.json")])
        with contextlib.redirect_stdout(io.StringIO()):
            records = m["evaluate_pred"].main(["--config", RECIPE, "--pred",
                                               path])
        veh = [r for r in records if r["class"] == "veh"]
        finite = all(math.isfinite(v) for r in veh for v in r.values()
                     if isinstance(v, float))
        print(f"[14] (a) tools.test on the built validation split at epoch "
              f"1: {len(outputs)} frames in {BUILD_FRAMES // 2} steps of B=2 "
              f"({tgot['fwd']} conv3x3 and {tgot['meta_kernel_taps']} taps "
              f"launches), {n_det} detections; "
              f"create_prediction_bin_3d: {n_out} objects; evaluate_pred: "
              f"{json.dumps(veh)}")
        if n_out != n_det or len(veh) != 1 or veh[0]["frames"] != \
                BUILD_FRAMES or not finite:
            fail(f"export {n_out} of {n_det} detections, AP {records}")

        # --------------------------------------------------- (b) KITTI
        kroot = os.path.join(tmp, "kitti")
        scans, kboxes = kitti_root(kroot, SEED + 141, KITTI_SCANS,
                                   KITTI_POINTS)
        kout = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            with contextlib.redirect_stdout(io.StringIO()):
                kout[where] = kcli.main([
                    "--kitti-root", kroot, "--out-dir",
                    os.path.join(tmp, f"kitti_{where}"), "--split",
                    "training", "--width", str(KITTI_W), "--device",
                    d.type])
        n_diff = n_band_px = n_band = n_face = n_count_diff = 0
        for scan, csa, a, b in zip(scans, kboxes, kout["card"],
                                   kout["cpu"]):
            ia = np.load(a["pc_url"])["range_image"]
            ib = np.load(b["pc_url"])["range_image"]
            band = edge_points(torch, scan, KITTI_W)
            row, col, _ = kitti.pixel_indices(torch.from_numpy(scan), KITTI_W)
            near = set((row.numpy()[band] * KITTI_W
                        + col.numpy()[band]).tolist())
            rc, cc, _ = kitti.pixel_indices(
                torch.from_numpy(scan).to(dev), KITTI_W)
            near |= set((rc.cpu().numpy()[band] * KITTI_W
                         + cc.cpu().numpy()[band]).tolist())
            diff = np.nonzero((ia != ib).any(-1).ravel())[0]
            n_diff += len(diff)
            n_band += int(band.sum())
            n_band_px += len(near)
            if not set(diff.tolist()) <= near:
                fail("the card's KITTI image differs from the CPU's away "
                     "from the row and column boundaries")
            if not np.array_equal(a["gt_bbox_csa"], b["gt_bbox_csa"]):
                fail("KITTI boxes differ, card vs CPU")
            faces = face_points(scan, a["gt_bbox_csa"])
            n_face += int(faces.sum())
            dc = np.abs(a["points_in_box"] - b["points_in_box"])
            n_count_diff += int(dc.sum())
            if (dc > faces.sum(1)).any() or (a["points_in_box"]
                                             < KITTI_BOX_POINTS).any():
                fail(f"points in box: card {a['points_in_box']}, CPU "
                     f"{b['points_in_box']}")
        # a farther point planted last on an occupied pixel loses (a
        # last-writer-wins scatter would keep it); intensity 2 marks it
        p = scans[0][:1]
        far = np.concatenate([p[:, :3] * 1.0005, [[2.0]]], 1).astype(
            np.float32)
        r2, c2, _ = kitti.pixel_indices(
            torch.from_numpy(np.concatenate([p, far])).to(dev), KITTI_W)
        img = kitti.build_range_image(np.concatenate([scans[0], far]),
                                      KITTI_W, device=dev)
        won = img[r2[0], c2[0]].cpu().numpy()
        if bool(r2[0] != r2[1]) or bool(c2[0] != c2[1]) or won[4] == 2.0 \
                or won[0] > np.linalg.norm(p[0, :3]):
            fail(f"the planted far point: pixels {r2.tolist()} "
                 f"{c2.tolist()}, winner {won}")
        t_ms = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            kitti.build_range_image(scans[0], KITTI_W, device=d)
            sync()
            t0 = time.perf_counter()
            for s in scans:
                kitti.build_range_image(s, KITTI_W, device=d).cpu()
            t_ms[where] = 1e3 * (time.perf_counter() - t0) / len(scans)
        print(f"[14] (b) KITTI: {KITTI_SCANS} scans of {KITTI_POINTS} "
              f"points through tools.create_range_image_in_kitti on the "
              f"card and the CPU: {n_diff} of {KITTI_SCANS}x64x{KITTI_W} "
              f"pixels differ, all at pixels of the {n_band} points within "
              f"{EDGE_BAND} of a row or column boundary ({n_band_px} "
              f"pixels); ties at the nearest range: "
              f"{sum(kitti.range_image_ties(s, KITTI_W, dev) for s in scans)}"
              f"; points in box equal but {n_count_diff} ({n_face} points "
              f"within {FACE_BAND} m of a face); the planted farther point "
              f"loses its pixel; range image ms a scan: card "
              f"{t_ms['card']:.2f}, CPU {t_ms['cpu']:.2f}")

        # one train step and one eval step on the KITTI records
        kcfg = m["load_config"](RECIPE, is_train=True).replace(
            base_lr=0.01, warmup_epochs=0)
        host = [m["record_to_inputs"](r, kcfg.pad_field, kcfg.max_gt_boxes)
                for r in kout["card"][:2]]
        kb = {k: np.stack([h[k] for h in host]) for k in host[0]}
        model = m["RangeDet"](**kcfg.model_kwargs())
        model.init_from(torch.Generator().manual_seed(SEED))
        kstate = m["create_train_state"](model.to(dev), kcfg, 100, seed=None)
        sync()
        reset_counts(m)
        km = m["make_train_step"](kstate, kcfg)(
            m["batch_to_device"](kb, dev))
        sync()
        got = read_counts(m)
        ecfg = m["load_config"](RECIPE, is_train=False)
        einputs = m["build_eval_inputs"](kb, ecfg, dev)
        sync()
        reset_counts(m)
        eout = m["make_eval_step"](kstate.model.eval(), ecfg)(einputs)
        sync()
        egot = read_counts(m)
        boxes = eout["veh"]["boxes"][eout["veh"]["valid"]]
        print(f"[14] (b) one train step on 2 KITTI records (64x{KITTI_W} "
              f"padded to {kcfg.pad_field[1]}): launches = [6]'s per step: "
              f"{got == per_step}, total_loss "
              f"{float(km['total_loss']):.4f}; one B=2 eval step: "
              f"{egot['fwd']} conv3x3 and {egot['meta_kernel_taps']} taps "
              f"launches (want {n_fwd}, {n_meta}), "
              f"{int(eout['veh']['valid'].sum())} boxes, finite "
              f"{bool(torch.isfinite(boxes).all())}")
        if got != per_step or not math.isfinite(float(km["total_loss"])) \
                or not bool(torch.isfinite(boxes).all()) \
                or egot != dict(per_frame):
            fail(f"KITTI steps: launches {got} and {egot}, expected "
                 f"{per_step} and {per_frame}")
        del kstate, model
    print(f"[14] the chain from raw frames in "
          f"{time.perf_counter() - t_phase:.1f} s")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rangedet_tpu_torch import _build
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.data.synthetic import make_batch
    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from rangedet_tpu_torch.models import RangeDet, layers
    from rangedet_tpu_torch.models.detector import (
        build_train_targets,
        compute_losses,
        run_inference,
    )
    from rangedet_tpu_torch.ops import conv3x3, nms
    from rangedet_tpu_torch.ops import iou_target as iou_mod
    from rangedet_tpu_torch.data.synthetic import write_waymo_files
    from rangedet_tpu_torch.data import augment, waymo
    from rangedet_tpu_torch.data.waymo import record_to_inputs
    from rangedet_tpu_torch.ops import meta_block
    from rangedet_tpu_torch.ops import meta_kernel as taps
    from rangedet_tpu_torch.tools import create_prediction_bin_3d as bin_cli
    from rangedet_tpu_torch.tools import eval_checkpoint, evaluate_pred
    from rangedet_tpu_torch.tools import test as test_cli
    from rangedet_tpu_torch.tools import train as train_cli
    from rangedet_tpu_torch.data import device_cache, synthetic_device
    from rangedet_tpu_torch.ops import assigner as ops_assigner
    from rangedet_tpu_torch.ops import boxes as ops_boxes
    from rangedet_tpu_torch.tools import overfit_probe, quality_probe
    from rangedet_tpu_torch.train.checkpoint import (
        checkpoint_path,
        latest_epoch,
        restore_checkpoint,
    )
    from rangedet_tpu_torch.train import train_step as train_step_mod
    from rangedet_tpu_torch.parallel import dist as pdist
    from rangedet_tpu_torch.train.state import create_train_state
    from rangedet_tpu_torch.train.train_step import (
        batch_to_device,
        make_train_step,
    )

    # exact f32 references: no TF32 in the plain convs and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ------------------------------------------------------------ phase 1
    print(_smi())  # name, power limit, as nvidia-smi gives them
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load()
    print(f"[1] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc per source, in parallel, and a link: "
          f"{_build.build_seconds:.2f} s) -> {_build.library_path()}")
    for line in _build.build_log.splitlines():
        if any(k in line for k in ("==", "registers", "spill", "error")):
            print(f"[1] nvcc: {line.strip()}")

    cfg = load_config(RECIPE, is_train=False)
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    eval_step = make_eval_step(model, cfg)
    H = cfg.pad_field[0]

    # ------------------------------------------------------------ phase 2
    # the conv shapes of the path, read off one B=1 forward
    shapes = {}
    real_conv = conv3x3.conv3x3_bhcw

    def record(x, w, scale=None, bias=None, stride_w=1, stats=False):
        key = (x.shape[2], w.shape[3], x.shape[3], stride_w,
               scale is not None)
        shapes[key] = shapes.get(key, 0) + 1
        return real_conv(x, w, scale, bias, stride_w, stats)

    inputs1 = build_eval_inputs(
        make_batch(cfg, 1, seed=SEED, num_boxes=20), cfg, dev)
    with mock.patch.object(conv3x3, "conv3x3_bhcw", record), \
            torch.inference_mode():
        model(inputs1["input_data"], inputs1["coord"])
    largest = max(shapes, key=lambda k: k[0] * k[1] * k[2] / k[3])
    cases = [(1, k) for k in sorted(shapes)] + [(4, largest)]
    print(f"[2] {len(shapes)} distinct conv shapes in the B=1 forward, "
          f"{sum(shapes.values())} launches; plus the largest at B=4")
    print("[2]  B    Ci    Co     W s ingest n/fwd  max_abs_err    "
          "tol_ok  kernel_ms   plain_ms cudnn_bf16_ms")
    g = torch.Generator(device=dev).manual_seed(SEED)
    serve = KernelTotals()  # sums over the launches of one B=1 forward
    serve_split = {}
    big_ms = big_plain_ms = None
    for B, (Ci, Co, W, s, ingest) in cases:
        x = torch.randn(B, H, Ci, W, device=dev, generator=g).bfloat16()
        w = (torch.randn(3, 3, Ci, Co, device=dev, generator=g)
             / (3.0 * Ci ** 0.5)).bfloat16()
        sc = bi = None
        if ingest:
            sc = 1.0 + 0.3 * torch.randn(Ci, device=dev, generator=g)
            bi = 0.2 * torch.randn(Ci, device=dev, generator=g)
        y = conv3x3.conv3x3_bhcw(x, w, sc, bi, s)
        torch.cuda.synchronize()
        ref = conv3x3.conv3x3_bhcw_plain(x, w, sc, bi, s,
                                         out_dtype=torch.float32)
        ok, e = _bf16_ok(y, ref)
        if not ok:
            raise SystemExit(f"[2] conv3x3 kernel disagrees at B={B} "
                             f"Ci={Ci} Co={Co} W={W} s={s} "
                             f"ingest={ingest}: max err {e}")
        if not torch.equal(y, conv3x3.conv3x3_bhcw(x, w, sc, bi, s)):
            raise SystemExit(f"[2] conv3x3 kernel repeat differs at B={B} "
                             f"Ci={Ci} Co={Co} W={W} s={s}")
        k_ms = _time_ms(lambda: conv3x3.conv3x3_bhcw(x, w, sc, bi, s))
        p_ms = _time_ms(lambda: conv3x3.conv3x3_bhcw_plain(x, w, sc, bi,
                                                           s))
        # for scale only, not a reference: cuDNN's bf16 conv, no ingest
        xn = x.permute(0, 2, 1, 3).contiguous(
            memory_format=torch.channels_last)
        wn = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        c_ms = _time_ms(lambda: torch.nn.functional.conv2d(
            xn, wn, stride=(1, s), padding=1))
        n = shapes[(Ci, Co, W, s, ingest)] if B == 1 else 0
        Wo = W // s
        serve.add(n, k_ms, p_ms, _bound_ms(
            2 * B * H * Wo * Co * Ci * 9,
            2 * (B * H * Ci * W + 9 * Ci * Co + B * H * Co * Wo), PEAK_BF16),
            c_ms, e)
        if B == 4:
            big_ms, big_plain_ms = k_ms, p_ms
        print(f"[2] {B:2d} {Ci:5d} {Co:5d} {W:5d} {s} {int(ingest):6d} "
              f"{n:5d} {e:12.6g} {str(ok):>9} {k_ms:10.4f} {p_ms:10.4f} "
              f"{c_ms:13.4f}")
        print("[2]   " + conv_device(
            lambda: conv3x3.conv3x3_bhcw(x, w, sc, bi, s),
            2 * B * H * Wo * Co * Ci * 9, serve_split if B == 1 else {}, n))
    print(f"[2] conv3x3 per B=1 forward (sum over launches): kernel "
          f"{serve.ms:.3f} ms, plain {serve.plain_ms:.3f} ms, cuDNN "
          f"{serve.library_ms:.3f} ms, bound {serve.bound_ms:.3f} ms "
          f"({serve.bound_by()}); largest shape at B=4: kernel "
          f"{big_ms:.4f} ms, plain {big_plain_ms:.4f} ms")
    conv_gate(2, "conv3x3 forward over the B=1 forward", serve, serve_split,
              FWD_CUDNN_MAX)

    # ------------------------------------------------------------ phase 3
    expected, how = conv_launches(cfg)
    n_taps = meta_units(cfg) if cfg.use_pallas_meta else 0
    print(f"[3] expected conv3x3 launches per forward: {how}; Meta-Kernel "
          f"taps kernel launches per forward: {n_taps}")
    for B in (4, 1):
        inputs = build_eval_inputs(
            make_batch(cfg, B, seed=SEED, num_boxes=20), cfg, dev)
        torch.cuda.synchronize()
        conv3x3.reset_counts()
        taps.reset_counts()
        nms.reset_counts()
        out = eval_step(inputs)
        torch.cuda.synchronize()
        launches, taps_launches = conv3x3.LAUNCHES, taps.LAUNCHES
        if launches != expected or taps_launches != n_taps:
            raise SystemExit(f"[3] B={B}: {launches} conv3x3 and "
                             f"{taps_launches} taps launches, expected "
                             f"{expected} and {n_taps}")
        if nms.LAUNCHES != 1:
            raise SystemExit(f"[3] B={B}: {nms.LAUNCHES} WNMS launches, "
                             f"expected one an eval step, every class's "
                             f"rows in it")
        if B == 4:  # veh.eval.b4's step
            wnms_launches_b4 = nms.LAUNCHES
        res = out["veh"]
        boxes, valid = res["boxes"], res["valid"]
        if not (torch.isfinite(boxes[valid]).all()
                and tuple(boxes.shape) == (B, cfg.post_nms_top_n["veh"],
                                           8)):
            raise SystemExit(f"[3] B={B}: non-finite or misshapen boxes")

        with torch.inference_mode():
            got = model(inputs["input_data"], inputs["coord"])
            with mock.patch.object(conv3x3, "conv3x3_bhcw",
                                   conv3x3.conv3x3_bhcw_plain), \
                    mock.patch.object(taps, "meta_kernel_taps",
                                      taps.meta_kernel_taps_plain):
                want = model(inputs["input_data"], inputs["coord"])
        rels = []
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            if not torch.isfinite(a).all():
                raise SystemExit(f"[3] B={B}: non-finite logits/deltas")
            rels.append(((a - b).abs().max() / b.abs().max()).item())
        rel = max(rels)
        print(f"[3] B={B}: kernel vs plain path, max|a-b|/max|b| per "
              f"output (logits by level, then deltas): "
              + " ".join(f"{r:.4g}" for r in rels))
        if rel > MODEL_TOL:
            raise SystemExit(f"[3] B={B}: kernel path vs plain path "
                             f"max rel err {rel:.3g} > {MODEL_TOL}")

        # the WNMS alone, on the candidates this step gave it
        captured = {}
        real_wnms = nms.weighted_nms

        def grab(*a, **kw):
            captured["args"], captured["kw"] = a, kw
            return real_wnms(*a, **kw)

        with mock.patch.object(nms, "weighted_nms", grab), \
                torch.inference_mode():
            run_inference(*got, inputs, cfg)
        torch.cuda.reset_peak_memory_stats()
        step_ms = _median_ms(lambda: eval_step(inputs))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with torch.inference_mode():
            fwd_ms_b = _median_ms(
                lambda: model(inputs["input_data"], inputs["coord"]))
            wnms_ms = _median_ms(
                lambda: real_wnms(*captured["args"], **captured["kw"]))
        n_valid = int(captured["args"][2].sum())
        if B == 4:  # veh.eval.b4's shapes
            with torch.inference_mode():
                wnms_b4 = wnms_check(torch, nms, captured["args"],
                                     captured["kw"])
        print(f"[3] B={B}: {launches} conv3x3 and {taps_launches} taps "
              f"launches/forward; outputs "
              f"finite; kernel vs plain path max rel err {rel:.4g} "
              f"(bound {MODEL_TOL}); eval step median {step_ms:.2f} ms "
              f"(forward {fwd_ms_b:.2f} ms, WNMS {wnms_ms:.2f} ms = "
              f"{100 * wnms_ms / step_ms:.1f}%); {n_valid} valid "
              f"candidates, {int(valid.sum())} boxes, truncated "
              f"{res['truncated'].tolist()}; peak memory {peak:.2f} GiB")
    # of the B=1 step, the last one
    serve_launches, serve_taps_launches = launches, taps_launches
    del model, eval_step

    # ------------------------------------------------------------ phase 4
    with tempfile.TemporaryDirectory() as tmp:
        path = test_cli.main(["--config", RECIPE, "--synthetic", "2",
                              "--device", "cuda", "--output",
                              os.path.join(tmp, "pred.pkl")])
        with open(path, "rb") as f:
            anno, outputs = pickle.load(f), pickle.load(f)
    if sorted(outputs) != ["synthetic_0", "synthetic_1"] or len(anno) != 2:
        raise SystemExit(f"[4] unexpected pickle keys {sorted(outputs)}")
    n_det = 0
    for rec in outputs.values():
        det = rec["det_xyzlwhyaws"]["veh"]
        if det.ndim != 2 or det.shape[1] != 8 or not np.isfinite(det).all():
            raise SystemExit("[4] malformed detections")
        n_det += len(det)
    print(f"[4] tools.test: 2 frames, {n_det} detections, pickle read "
          f"back")

    # ------------------------------------------------------------ phase 5
    # the setting of tests/test_model_train.py: base_lr 0.01, no warmup
    tcfg = load_config(RECIPE, is_train=True).replace(base_lr=0.01,
                                                      warmup_epochs=0)
    rmodel = RangeDet(**tcfg.model_kwargs())
    rmodel.init_from(torch.Generator().manual_seed(SEED))
    rstate = create_train_state(rmodel.to(dev), tcfg, STEPS_PER_EPOCH,
                                seed=None)
    recorded = record_train_step(
        make_train_step(rstate, tcfg),
        batch_to_device(make_batch(tcfg, 2, seed=SEED, num_boxes=20),
                        dev),
        conv3x3, iou_mod, layers, meta_block)
    del rmodel, rstate
    totals = phase5(torch, conv3x3, iou_mod, layers, meta_block, taps,
                    recorded, H, dev)
    earlier = dict(zip(("fwd", "dgrad", "wgrad"), map(set, recorded[:3])))
    del recorded

    # ------------------------------------------------------------ phase 6
    mods = dict(conv3x3=conv3x3, iou=iou_mod, meta=meta_block, taps=taps,
                RangeDet=RangeDet,
                make_batch=make_batch, batch_to_device=batch_to_device,
                create_train_state=create_train_state,
                make_train_step=make_train_step,
                build_train_targets=build_train_targets,
                compute_losses=compute_losses)
    launches, _ = phase6(torch, mods, tcfg, dev)

    # ------------------------------------------------------------ phase 7
    mods.update(make_eval_step=make_eval_step,
                build_eval_inputs=build_eval_inputs,
                write_waymo_files=write_waymo_files,
                record_to_inputs=record_to_inputs, load_config=load_config,
                latest_epoch=latest_epoch, checkpoint_path=checkpoint_path,
                restore_checkpoint=restore_checkpoint, train_cli=train_cli,
                test_cli=test_cli, evaluate_pred=evaluate_pred,
                eval_checkpoint=eval_checkpoint)
    taps_totals = phase7(torch, mods, cfg, dev)
    phase7_files(torch, mods, cfg, dev, launches)

    # ------------------------------------------------------------ phase 8
    mods.update(layers=layers, nms=nms, run_inference=run_inference,
                augment=augment, waymo=waymo, bin_cli=bin_cli)
    mc_iou, mc_launches, mc_serve = phase8(torch, mods, dev)

    # ------------------------------------------------------------ phase 9
    wide, wide_launches, wide_taps, wide_taps_launches = phase9(
        torch, mods, dev, earlier)

    # ----------------------------------------------------------- phase 10
    mods.update(train_step=train_step_mod)
    loader = phase10(torch, mods, tcfg, dev, launches)

    # ----------------------------------------------------------- phase 11
    mods.update(device_cache=device_cache, synthetic_device=synthetic_device,
                quality_probe=quality_probe, overfit_probe=overfit_probe,
                assign=ops_assigner.assign_points_to_boxes,
                points_per_box=ops_assigner.points_per_box,
                csa_to_corners3d=ops_boxes.csa_to_corners3d)
    phase11(torch, mods, tcfg, dev, launches, loader)

    # ----------------------------------------------------------- phase 12
    mods.update(pdist=pdist)
    b1, b1_launches = phase12(torch, mods, tcfg, dev, launches)

    # ----------------------------------------------------------- phase 13
    wide_w, width_launches = phase13(torch, mods, tcfg, dev, launches)

    # ----------------------------------------------------------- phase 14
    phase14(torch, mods, tcfg, dev, launches)

    # one entry per kernel and path: the serving forward (launches of the
    # B=1 eval step of phase 3, times of one B=1 forward in phases 2 and
    # 7), then the B=2 train step (phases 6 and 5)
    conv_src = "rangedet_tpu_torch/csrc/conv3x3_bhcw.cu"
    conv_tpu = "rangedet_tpu/ops/conv_pallas.py:252"
    meta_src = "rangedet_tpu_torch/csrc/meta_block.cu"
    entries = []
    for path, name, t, n, source, replaces in (
        ("serve", "conv3x3_bhcw", serve, serve_launches, conv_src, conv_tpu),
        ("serve", "meta_kernel_taps", taps_totals[1], serve_taps_launches,
         meta_src, "rangedet_tpu/ops/meta_kernel_pallas.py:138"),
        ("serve_b4", "weighted_nms", wnms_b4, wnms_launches_b4,
         "rangedet_tpu_torch/csrc/wnms.cu",
         "none (rangedet_tpu/ops/nms.py:weighted_nms, a lax.while_loop)"),
        ("serve_multiclass", "weighted_nms", mc_serve["wnms"],
         mc_serve["wnms_launches"], "rangedet_tpu_torch/csrc/wnms.cu",
         "none (rangedet_tpu/ops/nms.py:weighted_nms, a lax.while_loop)"),
        ("train", "conv3x3_bhcw_train", totals["fwd"], launches["fwd"],
         conv_src, conv_tpu),
        ("train", "conv3x3_dgrad", totals["dgrad"], launches["dgrad"],
         conv_src, conv_tpu),
        ("train", "conv3x3_wgrad", totals["wgrad"], launches["wgrad"],
         "rangedet_tpu_torch/csrc/conv3x3_wgrad.cu",
         "rangedet_tpu/ops/conv_pallas.py:452"),
        ("train", "iou_target", totals["iou"], launches["iou"],
         "rangedet_tpu_torch/csrc/iou_target.cu",
         "rangedet_tpu/ops/iou_target_pallas.py:193"),
        ("train", "meta_stats", totals["meta_stats"], launches["meta_stats"],
         meta_src, "rangedet_tpu/ops/meta_block_pallas.py:338"),
        ("train", "meta_agg", totals["meta_agg"], launches["meta_agg"],
         meta_src, "rangedet_tpu/ops/meta_block_pallas.py:368"),
        ("train", "meta_block_bwd", totals["meta_block_bwd"],
         launches["meta_block_bwd"], meta_src,
         "rangedet_tpu/ops/meta_block_pallas.py:411"),
        ("train_multiclass", "iou_target", mc_iou, mc_launches["iou"],
         "rangedet_tpu_torch/csrc/iou_target.cu",
         "rangedet_tpu/ops/iou_target_pallas.py:193"),
        ("train_tpuopt", "meta_stats", wide["meta_stats"],
         wide_launches["meta_stats"], meta_src,
         "rangedet_tpu/ops/meta_block_pallas.py:338"),
        ("train_tpuopt", "meta_agg", wide["meta_agg"],
         wide_launches["meta_agg"], meta_src,
         "rangedet_tpu/ops/meta_block_pallas.py:368"),
        ("train_tpuopt", "meta_block_bwd", wide["meta_block_bwd"],
         wide_launches["meta_block_bwd"], meta_src,
         "rangedet_tpu/ops/meta_block_pallas.py:411"),
        ("serve_tpuopt", "meta_kernel_taps", wide_taps[1],
         wide_taps_launches, meta_src,
         "rangedet_tpu/ops/meta_kernel_pallas.py:138"),
        *(("train_b1", name, b1[key], b1_launches[key], source, replaces)
          for name, key, source, replaces in (
              ("conv3x3_bhcw_train", "fwd", conv_src, conv_tpu),
              ("conv3x3_dgrad", "dgrad", conv_src, conv_tpu),
              ("conv3x3_wgrad", "wgrad",
               "rangedet_tpu_torch/csrc/conv3x3_wgrad.cu",
               "rangedet_tpu/ops/conv_pallas.py:452"),
              ("iou_target", "iou", "rangedet_tpu_torch/csrc/iou_target.cu",
               "rangedet_tpu/ops/iou_target_pallas.py:193"),
              ("meta_stats", "meta_stats", meta_src,
               "rangedet_tpu/ops/meta_block_pallas.py:338"),
              ("meta_agg", "meta_agg", meta_src,
               "rangedet_tpu/ops/meta_block_pallas.py:368"),
              ("meta_block_bwd", "meta_block_bwd", meta_src,
               "rangedet_tpu/ops/meta_block_pallas.py:411"))),
        *(("train_width", name, wide_w[key], width_launches[key], source,
           replaces) for name, key, source, replaces in (
              ("conv3x3_bhcw_train", "fwd", conv_src, conv_tpu),
              ("conv3x3_dgrad", "dgrad", conv_src, conv_tpu),
              ("conv3x3_wgrad", "wgrad",
               "rangedet_tpu_torch/csrc/conv3x3_wgrad.cu",
               "rangedet_tpu/ops/conv_pallas.py:452"),
              ("iou_target", "iou", "rangedet_tpu_torch/csrc/iou_target.cu",
               "rangedet_tpu/ops/iou_target_pallas.py:193"),
              ("meta_kernel_taps", "meta_kernel_taps", meta_src,
               "rangedet_tpu/ops/meta_kernel_pallas.py:138"))),
    ):
        entries.append({
            "name": name, "path": path, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": t.err,
            "ms": t.ms, "plain_ms": t.plain_ms, "bound_ms": t.bound_ms,
            "bound_by": t.bound_by(),
            "library_ms": (t.library_ms if name.startswith("conv3x3")
                           else None),
        })
        if source == meta_src:
            entries[-1]["f32_bound_ms"] = t.f32_bound_ms
        if name == "iou_target":  # its prep and clip kernels, the old path
            entries[-1].update(t.extra, prep_launches={
                "train_multiclass": mc_launches, "train_b1": b1_launches,
                "train_width": width_launches,
            }.get(path, launches)["iou_prep"])
    print(_smi())  # the card beside the numbers of the line below
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--cli-rank"]:
        cli_rank_main(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        main()
