"""The IoU target (csrc/iou_target.cu: the candidate prep and the clip) on
the inputs one full-size B=2 train step of ``rangedet_veh_wo_aug_4_18e``
gives it (seeded random weights, synthetic frames), one call per level:

    python -m rangedet_tpu_torch.tools.profile_iou [--against DIR]
        [--schedules 8x32 1x32] [--num-boxes 200]

For each level: the output against the plain version (chip_smoke's
IOU_TOL), the prep's nv and live candidate rows against
``prepare_candidates``' (the count of blocks that differ, by
``prep_diff``), whether two calls give the same bits, the clip's bound
over the pairs the candidate contract runs and over the live ones; then for each path the prep's and the clip's time
by CUDA events (the mean of 10 back-to-back calls, host work included),
their sum, the device launches per call and the device ms of each part by
torch.profiler, and the prep's peak memory beyond what was allocated
before it (its outputs included). With ``--against DIR``, a ``csrc``
directory of another build (e.g. the parent commit's, unpacked under the
git-ignored build/), the old device path runs in turns with this one: the
plain prep in torch ops (``prepare_candidates``, blocked planar copies
included) and that build's ``iou_target_run`` over its output, then the
copy back to (B, H, W); its output is compared with this build's.
``--schedules`` times this build's clip at other schedules, given as
SUBSxCHUNK (sub-tiles a 2048-pixel block, candidates a kernel block; 8x8
is the one shipped), in turns with the shipped one, each checked
bit-equal to it. ``--num-boxes`` sets the synthetic frames' boxes (20, as
chip_smoke's step; 200 fills the recipe's max_gt_boxes, a crowded
frame). Sums over the three
levels are a B=2 step's. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path
from unittest import mock

import torch

from .. import _build
from ..ops import iou_target as iou
from ..ops.boxes import polygon_area
from .profile_eval import _self_device_us
from .profile_wgrad import events_ms

RECIPE = "rangedet_veh_wo_aug_4_18e"
SEED = 0
IOU_TOL = 1e-5  # chip_smoke's: kernel vs plain, max abs
# the H100 SXM's published peaks (NVIDIA data sheet)
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations: per (pixel, candidate) clip; per pixel of the prep (the
# centre, the predicted circumradius, the block max); per (pixel, GT of
# nonzero area) of the prep (distance, square, min); per pair of GT rows
# of a block's rank (compare, add)
OPS_PER_PAIR = 600
PREP_OPS_PER_PIXEL = 24
PREP_OPS_PER_PIXEL_GT = 6
RANK_OPS_PER_GT_PAIR = 2


def record_calls(dev, num_boxes=20):
    """The IoU target's calls of one B=2 train step's losses: [(deltas, pc,
    gt_corners, topk_gt)], one per level and class, the deltas as the
    step passes them (class k's 8 channels of the head's output)."""
    from ..configs import load_config
    from ..data.synthetic import make_batch
    from ..models import RangeDet
    from ..models.detector import build_train_targets, compute_losses
    from ..train.train_step import batch_to_device

    calls, real = [], iou.iou_target

    def rec(d, p, gt, topk_gt=32):
        calls.append((d.clone(), p.clone(), gt.clone(), topk_gt))
        return real(d, p, gt, topk_gt)

    cfg = load_config(RECIPE, is_train=True)
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    model = model.to(dev).train()
    batch = batch_to_device(make_batch(cfg, 2, seed=SEED,
                                               num_boxes=num_boxes), dev)
    with mock.patch.object(iou, "iou_target", rec), torch.no_grad():
        targets = build_train_targets(batch, cfg)
        cls, reg = model(batch["input_data"], batch["coord"])
        compute_losses(cls, reg, targets, cfg)
    return calls


def iou_work(deltas, gt_corners, nv, Gk):
    """(f32 operations, bytes) of one IoU target call, per part: "prep",
    "clip", "clip_live" and "all" (the whole function: the 6 delta and 2
    point channels it reads, the GT corners, the output; cand and nv are
    its intermediates); and the clip's (pixel, candidate) pairs, padded and
    live. "clip" counts the pairs the candidate contract has the clip run,
    the ceil(nv/8)*8 candidates of each block times its pixels (the TPU
    kernel's trip count, kept so the output equals the plain version's bit
    for bit); "clip_live" only the first nv of them, the candidates whose
    circumcircles reach the block (the rows past nv add IoU 0)."""
    B, H, W, _ = deltas.shape
    N, M = H * W, gt_corners.shape[1]
    nb = -(-N // iou.TILE)
    valid = torch.tensor([min(iou.TILE, N - k * iou.TILE) for k in range(nb)],
                         device=nv.device).repeat(B)
    n8 = ((nv.long() + 7) // 8 * 8).clamp(max=Gk)
    pairs = int((n8 * valid).sum())
    live_pairs = int((nv.long() * valid).sum())
    live_gt = int((polygon_area(gt_corners.float()).abs() >= iou.EPS).sum())
    prep_ops = (PREP_OPS_PER_PIXEL * B * N + PREP_OPS_PER_PIXEL_GT * N
                * live_gt + RANK_OPS_PER_GT_PAIR * B * nb * M * M)
    cand_bytes = 4 * (B * nb * (Gk * 9 + 1))
    clip_bytes = 4 * B * N * 9 + cand_bytes
    work = {"prep": (prep_ops, 4 * B * N * 7 + 4 * B * M * 8 + cand_bytes),
            "clip": (OPS_PER_PAIR * pairs, clip_bytes),
            "clip_live": (OPS_PER_PAIR * live_pairs, clip_bytes)}
    work["all"] = (prep_ops + OPS_PER_PAIR * pairs,
                   4 * B * N * 9 + 4 * B * M * 8)
    return work, pairs, live_pairs


def bound_ms(ops, nbytes):
    """The least time: operations at the f32 peak or bytes at the memory
    rate, whichever is longer; and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def device_split(fn, parts, iters=3, tries=3):
    """Device ms and kernel launches per call of fn, by kernel name: parts
    maps a part's name to the kernel-name fragments it holds; kernels that
    match none go to "other". A profiler session that saw a part's kernel
    too few times (it drops events now and then) is run again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = {k: [0.0, 0] for k in (*parts, "other")}
        for e in prof.key_averages():
            us = _self_device_us(e)
            if us <= 0:
                continue
            name = next((k for k, frags in parts.items()
                         if any(f in e.key for f in frags)), "other")
            split[name][0] += us / iters / 1e3
            split[name][1] += e.count / iters
        if all(split[k][1] >= 1 for k in parts):
            return split
    return split


def peak_extra_mib(fn):
    """Peak device memory during fn() beyond what was allocated before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def prep_diff(cand, nv, pcand, pnv):
    """Blocks whose prep output differs from the plain prep's, counted
    three ways: nv; the GT corners of a live row (the first ceil(nv/8)*8:
    another GT chosen or another order); the area bits of a live row alone
    (the kernel adds the shoelace terms in corner order, torch's
    ``polygon_area`` in the order its reduction picks)."""
    Gk = cand.shape[1]
    n8 = ((pnv.long() + 7) // 8 * 8).clamp(max=Gk)
    live = torch.arange(Gk, device=nv.device)[None] < n8[:, None]
    bits = cand.view(torch.int32) != pcand.view(torch.int32)
    corners = (bits[..., :8].any(-1) & live).any(-1)
    area = (bits[..., 8] & live).any(-1) & ~corners
    return (int((nv != pnv).sum()), int(corners.sum()), int(area.sum()))


def check(call):
    """The gates of one call: (max abs error against the plain version,
    finite, prep_diff against ``prepare_candidates``, bit-equal repeat,
    cand, nv)."""
    d, p, gt, topk = call
    out = iou.iou_target(d, p, gt, topk)
    again = iou.iou_target(d, p, gt, topk)
    ref = iou.iou_target_plain(d, p, gt, topk)
    cand, nv, _ = iou.candidates(d, p, gt, topk)
    pcand, pnv = iou.prepare_candidates(d, p, gt, topk)[:2]
    return ((out - ref).abs().max().item(), bool(out.isfinite().all()),
            prep_diff(cand, nv, pcand, pnv),
            torch.equal(out.view(torch.int32), again.view(torch.int32)),
            cand, nv)


def old_path(lib, call):
    """The old device path on ``lib`` (a build with ``iou_target_run``):
    (prep, clip) callables; clip() returns the (B, H, W) output."""
    d, p, gt, topk = call
    B, H, W, _ = d.shape
    fn = lib.iou_target_run
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    prep = iou.prepare_candidates(d, p, gt, topk)

    def clip():
        cand, nv, dp, pp = prep
        out = torch.empty((cand.shape[0], iou.TILE), device=d.device)
        err = fn(cand.data_ptr(), nv.data_ptr(), dp.data_ptr(),
                 pp.data_ptr(), out.data_ptr(), cand.shape[0], cand.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"iou_target_run failed: cudaError {err}")
        return iou._unblock(out, (B, H, W))

    return (lambda: iou.prepare_candidates(d, p, gt, topk)), clip


def sass_per_pair(lib_path):
    """The clip kernel's SASS instructions per (pixel, candidate) pair, from
    ``cuobjdump -sass`` of the built library: the static count of the
    candidate loop (the shortest backward branch around the 32 division
    calls) less the divisions' slow paths, which a call jumps over; and
    how many of them are MUFU.RCP. None when there is no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    body = text.split("iou_clip_kernel", 1)[1].split("Function : ", 1)[0]
    ins = [(int(a, 16), t.strip()) for a, t in re.findall(
        r"/\*([0-9a-f]{4})\*/\s+([^;]*);", body)]
    loops = [(a, int(m.group(1), 16)) for a, t in ins
             for m in [re.search(r"BRA (?:!?P\d, )?0x([0-9a-f]+)", t)]
             if m and int(m.group(1), 16) < a]
    loops = [(lo, hi) for hi, lo in loops
             if sum("CALL" in t for a, t in ins if lo <= a <= hi) >= 32]
    if not loops:
        return None
    lo, hi = min(loops, key=lambda r: r[1] - r[0])
    loop = [(a, t) for a, t in ins if lo <= a <= hi]
    skipped = set()
    for a, t in loop:
        m = re.match(r"@!?P\d BRA 0x([0-9a-f]+)", t)
        if m and int(m.group(1), 16) > a:
            region = [b for b, u in loop if a < b < int(m.group(1), 16)]
            if any("CALL" in u for b, u in loop if b in region):
                skipped.update(region)
    fast = [t for a, t in loop if a not in skipped]
    return len(fast), sum("MUFU.RCP" in t for t in fast)


NEW_PARTS = {"prep": ("iou_prep_kernel",),
             "clip": ("iou_clip_kernel", "iou_clean_kernel")}
OLD_PARTS = {"clip": ("iou_target_kernel",)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="a csrc directory of a build with the old device "
                         "path's kernel, iou_target_run")
    ap.add_argument("--num-boxes", type=int, default=20,
                    help="boxes a synthetic frame (chip_smoke's step: 20; "
                         "the recipe pads to max_gt_boxes = 200)")
    ap.add_argument("--schedules", nargs="*", default=[],
                    help="other clip schedules, SUBSxCHUNK")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_iou needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"profile_iou on {smi}", flush=True)
    dev = torch.device("cuda")
    _build.load()
    sass = sass_per_pair(_build.library_path())
    print("clip kernel: " + ("SASS not read (no cuobjdump)" if sass is None
                             else f"{sass[0]} SASS instructions per (pixel, "
                             f"candidate) pair on the fast path, {sass[1]} "
                             f"of them MUFU.RCP (counted f32 operations: "
                             f"{OPS_PER_PAIR})"), flush=True)
    old_lib = (_build.load_from(args.against) if args.against is not None
               else None)
    schedules = [tuple(int(v) for v in s.split("x")) for s in args.schedules]
    failed = False
    tot = {}

    def add(key, v):
        tot[key] = tot.get(key, 0.0) + v

    for lvl, call in enumerate(record_calls(dev, args.num_boxes)):
        d, p, gt, topk = call
        err, finite, off, same, cand, nv = check(call)
        failed |= not (err <= IOU_TOL and finite and same)
        work, pairs, live_pairs = iou_work(d, gt, nv, cand.shape[1])
        out = torch.zeros(d.shape[:3], device=dev)
        new = {"prep": lambda: iou.candidates(d, p, gt, topk),
               "clip": lambda: iou.clip(cand, nv, d, p, out)}
        paths = {"new": new}
        if old_lib is not None:
            o_prep, o_clip = old_path(old_lib, call)
            paths["old"] = {"prep": o_prep, "clip": o_clip}
            o_out = o_clip()
            n_off = int((o_out.view(torch.int32) != iou.iou_target(
                d, p, gt, topk).view(torch.int32)).sum())
            print(f"level {lvl}: the old path's output differs from this "
                  f"build's at {n_off} of {o_out.numel()} pixels", flush=True)
        # events in turns: old, new, new, old
        order = ["old", "new", "new", "old"] if old_lib is not None else [
            "new", "new"]
        ms = {}
        for name in order:
            for part, fn in paths[name].items():
                ms.setdefault((name, part), []).append(events_ms(fn))
        b = {k: bound_ms(*w) for k, w in work.items()}
        print(f"level {lvl}: deltas {tuple(d.shape)} strides {d.stride()}, "
              f"{nv.numel()} blocks, Gk {cand.shape[1]}, nv sum "
              f"{int(nv.sum())} max {int(nv.max())}, {pairs} (pixel, "
              f"candidate) pairs ({live_pairs} live); max abs err "
              f"{err:.3g}, finite {finite}, blocks other than the plain "
              f"prep's in nv {off[0]}, in a live row's corners {off[1]}, "
              f"in a live row's area bits alone {off[2]}, bit-equal repeat "
              f"{same}; bound prep {b['prep'][0]:.4f} ms ({b['prep'][1]}), "
              f"clip {b['clip'][0]:.4f} ({b['clip'][1]}; over live pairs "
              f"{b['clip_live'][0]:.4f}), all {b['all'][0]:.4f} "
              f"({b['all'][1]})", flush=True)
        for k in ("prep", "clip", "clip_live", "all"):
            add(f"bound_{k}", b[k][0])
        for name, parts in paths.items():
            split = device_split(
                lambda: [fn() for fn in parts.values()],
                NEW_PARTS if name == "new" else OLD_PARTS)
            mib = peak_extra_mib(parts["prep"])
            t = {part: sum(ms[name, part]) / len(ms[name, part])
                 for part in parts}
            for part in parts:
                add(f"{name}_{part}", t[part])
                add(f"{name}_dev_{part}", split.get(part, [0.0])[0])
            add(f"{name}_dev_other", split["other"][0])
            launches = sum(v[1] for v in split.values())
            print(f"  {name} path: events prep {t['prep']:.4f} + clip "
                  f"{t['clip']:.4f} = {t['prep'] + t['clip']:.4f} ms (in "
                  f"turns: " + "; ".join(
                      f"{part} " + " ".join(f"{v:.4f}" for v in ms[name,
                                                                   part])
                      for part in parts)
                  + f"); device " + ", ".join(
                      f"{k} {v[0]:.4f} ms / {v[1]:g} launches"
                      for k, v in split.items())
                  + f" ({launches:g} launches a call); prep peak extra "
                  f"memory {mib:.1f} MiB", flush=True)
        if schedules:  # in turns with the shipped one: A B .. B A
            runs = [(iou.SUBS, iou.CHUNK), *schedules]
            ms_s = {sc: [] for sc in runs}
            for sc in runs + runs[::-1]:
                ms_s[sc].append(events_ms(lambda: iou.clip(cand, nv, d, p,
                                                           out, *sc)))
            ref = iou.clip(cand, nv, d, p, torch.zeros_like(out))
            for subs, chunk in schedules:
                o2 = iou.clip(cand, nv, d, p, torch.zeros_like(out), subs,
                              chunk)
                same_s = torch.equal(o2.view(torch.int32),
                                     ref.view(torch.int32))
                failed |= not same_s
                add(f"clip_{subs}x{chunk}", sum(ms_s[subs, chunk]) / 2)
                print(f"  clip at {subs}x{chunk}: " + " ".join(
                    f"{v:.4f}" for v in ms_s[subs, chunk]) + " ms against "
                    f"{iou.SUBS}x{iou.CHUNK}'s " + " ".join(
                        f"{v:.4f}" for v in ms_s[runs[0]])
                    + f" in turns, bit-equal to it {same_s}", flush=True)
    print("== over the step's calls: bound prep "
          f"{tot['bound_prep']:.4f}, clip {tot['bound_clip']:.4f} (over "
          f"live pairs {tot['bound_clip_live']:.4f}), all "
          f"{tot['bound_all']:.4f} ms; " + "; ".join(
              f"{name} path events prep {tot[name + '_prep']:.4f} + clip "
              f"{tot[name + '_clip']:.4f} = "
              f"{tot[name + '_prep'] + tot[name + '_clip']:.4f} ms, device "
              f"prep {tot[name + '_dev_prep']:.4f} clip "
              f"{tot[name + '_dev_clip']:.4f} other "
              f"{tot[name + '_dev_other']:.4f} ms"
              for name in ("new", "old") if name + "_prep" in tot)
          + f"; the new clip at {tot['new_clip'] / tot['bound_clip']:.2f}x "
          f"its bound ({tot['new_clip'] / tot['bound_clip_live']:.2f}x over "
          f"live pairs)" + "".join(
              f"; clip at {s}x{c} {tot[f'clip_{s}x{c}']:.4f} ms"
              for s, c in schedules), flush=True)
    if failed:
        raise SystemExit("profile_iou: a call failed its gates or repeat")


if __name__ == "__main__":
    main()
