"""The Meta-Kernel kernels of csrc/meta_block.cu (the forward kernel's
three modes: meta_stats, meta_agg, the eval taps; the block backward in
both modes) on the inputs one full-size B=2 train step and one B=4 and B=1
eval forward of a recipe give them (seeded random weights, synthetic
frames):

    python -m rangedet_tpu_torch.tools.profile_meta [--recipe NAME]
        [--against DIR]

The recipe sets the width: ``rangedet_veh_wo_aug_4_18e`` (the default)
runs the kernels' C=64 instance (Cm=32, Co=64), ``rangedet_veh_tpuopt_all_36e``
their C=128 instance (Cm=32, Co=128).

For each launch: the error against the plain version inside chip_smoke's
gates (for meta_agg the count of bf16 outputs that differ from the plain
version's; for the taps the count of elements that differ from the
training plain version's tap product a, ``ops/meta_block.py:_taps``, and
their largest distance in bf16 ulps), whether two calls give the same
bits, the time of one call by CUDA events (10 back-to-back calls, host
work included), its device time by torch.profiler split into the main
kernel and the reduction of the block partials, the f32 operations it
stands for (meta_work) in TFLOP/s of the main kernel's device time, and
two bounds: f32 FFMA (meta_work at 67 TFLOP/s, or its bytes) and tensor
cores (tc_bound_ms). With ``--against DIR``, a ``csrc`` directory of
another build (e.g. a parent commit's, unpacked under the git-ignored
build/), every launch of both builds is timed in turns; meta_agg and the
backward must be bit-equal, and for meta_stats and the taps the count of
elements that differ is printed (for the taps also each build's count of
elements other than the training plain version's a). A build from before
the kernels took their width as an argument (one instance, C=64) is
called through ``Abi64``. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path
from unittest import mock

import torch

from .. import _build
from .profile_wgrad import events_ms

# the H100 SXM's published peaks (NVIDIA data sheet)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
RECIPE = "rangedet_veh_wo_aug_4_18e"
SEED = 0
# chip_smoke's gates: bf16 outputs |a - b| <= 2^-6 |b| + 1e-3 max|b|, f32
# sums max|a - b| <= 1e-3 max|b|
REL_TOL, MAX_TOL, SUM_TOL = 2.0 ** -6, 1e-3, 1e-3
# kernel-name fragments of each launch's main kernel (the forward kernel's
# three modes are instantiations of one template); the reduction of the
# block partials is reduce_blocks_kernel
MAIN = {"stats": "meta_fwd_kernel", "agg": "meta_fwd_kernel",
        "taps": "meta_fwd_kernel", "bwd_agg": "meta_bwd_kernel",
        "bwd_stats": "meta_bwd_kernel"}


def meta_work(kind, B, H, W, C, Cm, Co):
    """(f32 operations, bytes) of one launch of a Meta-Kernel kernel over
    B*H*W pixels: each input read once, each output written once. Per
    pixel and tap the taps cost 2*C*Cm (MLP out) + 7*Cm (rel, MLP in, relu)
    + 2*C (bias, product), which is all kernel 7 ("taps") does; stats adds
    3*C; agg 3*C (fold, relu) + 2*C*Co; the agg backward 4*C*Co (A.gy, dA)
    + 8*C (dz, ds9, db9, da, dnb, dwt, dfeat) + 4*C*Cm + 9*Cm (MLP
    backward); the stats backward 6*C + 4*C*Cm + 9*Cm."""
    taps = 2 * C * Cm + 7 * Cm + 2 * C
    per = {"taps": taps, "stats": taps + 3 * C,
           "agg": taps + 3 * C + 2 * C * Co,
           "bwd_agg": taps + 4 * C * Co + 8 * C + 4 * C * Cm + 9 * Cm,
           "bwd_stats": taps + 6 * C + 4 * C * Cm + 9 * Cm}[kind]
    n = B * H * W
    feat = 2 * n * (C + 3)  # bf16 features and coordinates
    weights = 4 * (4 * Cm + Cm * C + C + (0 if kind == "taps" else 2 * 9 * C))
    out = {"taps": 2 * n * 9 * C,
           "stats": 4 * 2 * 9 * C, "agg": 2 * n * Co + 2 * 9 * C * Co,
           "bwd_agg": 2 * n * (C + 2 * Co) + 2 * 9 * C * Co
           + 4 * (9 * C * Co + 2 * 9 * C + 4 * Cm + Cm * C + C),
           "bwd_stats": 2 * n * C + 4 * (4 * Cm + Cm * C + C)}[kind]
    return 9 * n * per, feat + weights + out


def bound_ms(kind, B, H, W, C, Cm, Co):
    """The f32-FFMA bound: meta_work's operations at PEAK_F32 or its bytes,
    whichever is longer; in ms."""
    ops, nbytes = meta_work(kind, B, H, W, C, Cm, Co)
    return 1e3 * max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def tc_bound_ms(kind, B, H, W, C, Cm, Co):
    """The least time of a launch on the tensor cores: its contractions
    (the MLP's 2*C*Cm a pixel and tap, agg 2*C*Co more, the agg backward
    4*C*Co + 4*C*Cm more, the stats backward 4*C*Cm) at the bf16 peak, the
    rest of meta_work's operations at the f32 peak, or its bytes,
    whichever is longest; (ms, "operations" or "bytes")."""
    ops, nbytes = meta_work(kind, B, H, W, C, Cm, Co)
    per = {"taps": 2 * C * Cm, "stats": 2 * C * Cm,
           "agg": 2 * C * Cm + 2 * C * Co,
           "bwd_agg": 6 * C * Cm + 4 * C * Co, "bwd_stats": 6 * C * Cm}[kind]
    mma = 9 * B * H * W * per
    t_ops = max(mma / PEAK_BF16, (ops - mma) / PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def device_ms(fn, main, iters=3, tries=3):
    """Device ms per call: (main kernel, reduction) by kernel name under
    torch.profiler; None when ``tries`` profiled runs saw no main kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = [0.0, 0.0]
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0.0)
            if main in e.key:
                split[0] += us / iters / 1e3
            elif "reduce_blocks_kernel" in e.key:
                split[1] += us / iters / 1e3
        if split[0] > 0:
            return tuple(split)
    return None


def training_taps(feat, cb, w0, b0, w1, b1):
    """The tap product a of the training plain version
    (``ops/meta_block.py:_taps``: f32 from the same bf16 operands, rounded
    to feat.dtype) as the taps' (B, H, 9C, W) tensor."""
    from ..ops import meta_block as mb

    return torch.cat([a.to(feat.dtype) for _, a, *_ in mb._taps(
        feat, cb, w0, b0, w1, b1)], dim=2)


def ulps(a, b):
    """The distance of two bf16 tensors in bf16 ulps, elementwise (int32;
    -0 and +0 are one)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i >= 0, i, -(i & 0x7FFF))

    return (ordered(a) - ordered(b)).abs()


def _rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp(min=1e-30)).item()


def _bf16_ok(y, ref):
    err = (y.float() - ref).abs()
    return bool((err <= REL_TOL * ref.abs() + MAX_TOL * ref.abs().max())
                .all() and y.float().isfinite().all())


def record_launches(dev, recipe=RECIPE):
    """The Meta-Kernel launches of one B=2 train step (forward and
    backward) and of one B=4 and one B=1 eval forward of ``recipe``:
    [(work kind, label, args)]."""
    from ..configs import load_config
    from ..data.synthetic import make_batch
    from ..infer import build_eval_inputs
    from ..models import RangeDet
    from ..models.detector import build_train_targets, compute_losses
    from ..ops import meta_block as mb
    from ..ops import meta_kernel as taps
    from ..train.train_step import batch_to_device

    out = []
    real = {n: getattr(mb, n) for n in ("meta_stats", "meta_agg", "meta_bwd")}

    def keep(name):
        def rec(*args):
            kind = {"meta_stats": "stats", "meta_agg": "agg"}.get(
                name, f"bwd_{args[7] if len(args) > 7 else ''}")
            out.append((kind, "B=2 train step",
                         tuple(a.detach().clone() if hasattr(a, "detach")
                               else tuple(e.detach().clone() for e in a)
                               if isinstance(a, tuple) else a
                               for a in args)))
            return real[name](*args)
        return rec

    cfg = load_config(recipe, is_train=True)
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    model = model.to(dev).train()
    batch = batch_to_device(make_batch(cfg, 2, seed=SEED, num_boxes=20), dev)
    with mock.patch.multiple(mb, **{n: keep(n) for n in real}):
        targets = build_train_targets(batch, cfg)
        cls, reg = model(batch["input_data"], batch["coord"])
        compute_losses(cls, reg, targets, cfg)[0].backward()
    ecfg = load_config(recipe, is_train=False)
    model = model.eval()
    real_taps = taps.meta_kernel_taps
    for B in (4, 1):
        inputs = build_eval_inputs(make_batch(ecfg, B, seed=SEED,
                                              num_boxes=20), ecfg, dev)

        def rec(*args, B=B):
            out.append(("taps", f"B={B} eval forward",
                        tuple(a.detach().clone() for a in args)))
            return real_taps(*args)

        with mock.patch.object(taps, "meta_kernel_taps", rec), \
                torch.inference_mode():
            model(inputs["input_data"], inputs["coord"])
    return out


def case(kind, args):
    """One launch: a dict of measurements."""
    from ..ops import meta_block as mb
    from ..ops import meta_kernel as taps

    feat, _, w0 = args[:3]
    B, H, C, W = feat.shape
    Cm = w0.shape[1]
    Co, off = 0, None
    if kind == "stats":
        fn, plain = mb.meta_stats, mb.meta_stats_plain
        got, ref = fn(*args), plain(*args)
        ok = max(_rel(a, b) for a, b in zip(got, ref)) <= SUM_TOL
    elif kind == "agg":
        Co = args[8].shape[1]
        fn = mb.meta_agg
        got = fn(*args)
        ok = _bf16_ok(got, mb.meta_agg_plain(*args, out_dtype=torch.float32))
        off = (f"{int((got != mb.meta_agg_plain(*args)).sum())} bf16 "
               f"outputs other than the plain version's")
    elif kind == "taps":
        fn = taps.meta_kernel_taps
        got = fn(*args)
        ok = _bf16_ok(got, taps.meta_kernel_taps_plain(
            *(a.to(feat.dtype).float() for a in args)))
        d = ulps(got, training_taps(*args))
        off = (f"{int((d > 0).sum())} of {d.numel()} elements other than "
               f"the training plain version's a, at most "
               f"{int(d.max())} bf16 ulp")
        del d
    else:
        if kind == "bwd_agg":
            Co = args[6][2].shape[1]
        fn = mb.meta_bwd
        got = fn(*args)
        ref = mb.meta_bwd_plain(*args, out_dtype=torch.float32)
        ok = _bf16_ok(got[0], ref[0]) and max(
            _rel(a, b) for a, b in zip(got[1:], ref[1:])) <= SUM_TOL
    again = fn(*args)
    same = all(torch.equal(a, b) for a, b in zip(
        got if isinstance(got, tuple) else (got,),
        again if isinstance(again, tuple) else (again,)))
    ops, _ = meta_work(kind, B, H, W, C, Cm, Co)
    return dict(shape=f"B={B} H={H} C={C} W={W} Cm={Cm} Co={Co}", ok=ok,
                same=same, off=off, events=events_ms(lambda: fn(*args)),
                split=device_ms(lambda: fn(*args), MAIN[kind]), ops=ops,
                bound=bound_ms(kind, B, H, W, C, Cm, Co),
                tc=tc_bound_ms(kind, B, H, W, C, Cm, Co)[0])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", default=RECIPE,
                   help="the recipe whose launches to run: its Meta-Kernel "
                        "width picks the kernels' instance")
    p.add_argument("--against", type=Path, default=None,
                   help="a csrc directory of another build to compare and "
                        "time every launch against")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_meta needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"profile_meta on {smi}, recipe {args.recipe}", flush=True)
    dev = torch.device("cuda")
    failed = False
    sums = {}
    launches = record_launches(dev, args.recipe)
    for kind, label, a in launches:
        m = case(kind, a)
        failed |= not (m["ok"] and m["same"])
        s = sums.setdefault((kind, label), dict(n=0, events=0.0, main=0.0,
                                                reduce=0.0, bound=0.0,
                                                tc=0.0))
        s["n"] += 1
        for k in ("events", "bound", "tc"):
            s[k] += m[k]
        detail = "device time not measured"
        if m["split"] is not None:
            main_ms, red_ms = m["split"]
            s["main"] += main_ms
            s["reduce"] += red_ms
            detail = (f"device {main_ms:.4f} ms main + {red_ms:.4f} ms "
                      f"reduction ({m['ops'] / main_ms / 1e9:.1f} TFLOP/s "
                      f"f32-equivalent)")
        off = "" if m["off"] is None else f", {m['off']}"
        print(f"{kind} ({label}, {m['shape']}): gate "
              f"{'ok' if m['ok'] else 'FAILED'}{off}, bit-equal repeat "
              f"{m['same']}; events {m['events']:.4f} ms; {detail}; bound "
              f"{m['bound']:.4f} ms f32 FFMA, {m['tc']:.4f} ms tensor cores",
              flush=True)
    for (kind, label), s in sums.items():
        print(f"== {kind} over the {s['n']} launch(es) of the {label}: "
              f"events {s['events']:.3f} ms = {s['events'] / s['bound']:.2f}x "
              f"the f32 bound {s['bound']:.3f} ms, "
              f"{s['events'] / s['tc']:.1f}x the tensor-core bound "
              f"{s['tc']:.3f} ms; device {s['main']:.3f} + {s['reduce']:.3f} "
              f"ms", flush=True)
    if args.against is not None:
        failed |= not against(args.against, launches)
    if failed:
        raise SystemExit("profile_meta: a launch failed its gate or repeat")


class Abi64:
    """A build from before the kernels took their width (one instance, C=64,
    Cm=32, Co=64, named by ``meta_block_widths``; meta_stats_fwd and
    meta_kernel_taps without the pitch, meta_kernel_grid) behind the entry
    points the wrappers call now."""

    def __init__(self, lib):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        for name, types in {
                "meta_block_grid": [i32] * 4,
                "meta_block_part_floats": [i32],
                "meta_stats_fwd": [vp] * 8 + [i32] * 4 + [vp],
                "meta_agg_fwd": [vp] * 10 + [i32] * 5 + [vp],
                "meta_block_bwd": [vp] * 13 + [i32] * 6 + [vp],
                "meta_kernel_taps": [vp] * 7 + [i32] * 4 + [vp]}.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = types, i32
        self.lib = lib

    def meta_block_grid(self, kind, C, B, H, W):
        return self.lib.meta_block_grid(kind, B, H, W)

    def meta_block_part_floats(self, kind, C):
        return self.lib.meta_block_part_floats(kind)

    def meta_stats_fwd(self, *a):
        *ptrs, _, B, H, W, _, blocks, stream = a
        return self.lib.meta_stats_fwd(*ptrs, B, H, W, blocks, stream)

    def meta_agg_fwd(self, *a):
        *ptrs, _, B, H, W, pitch, blocks, stream = a
        return self.lib.meta_agg_fwd(*ptrs, B, H, W, pitch, blocks, stream)

    def meta_kernel_taps(self, *a):
        *ptrs, _, B, H, W, _, blocks, stream = a
        return self.lib.meta_kernel_taps(*ptrs, B, H, W, blocks, stream)

    def meta_block_bwd(self, *a):
        *ptrs, _, B, H, W, pitch, blocks, mode, stream = a
        return self.lib.meta_block_bwd(*ptrs, B, H, W, pitch, blocks, mode,
                                       stream)


def against(csrc, launches):
    """Every launch on this build and on the build of ``csrc``, on the same
    inputs, timed by events in turns. True when meta_agg and the backward
    are bit-equal across the two builds; meta_stats and the taps may
    differ (counted)."""
    from ..ops import meta_block as mb
    from ..ops import meta_kernel as taps

    fns = {"stats": mb.meta_stats, "agg": mb.meta_agg, "taps":
           taps.meta_kernel_taps, "bwd_agg": mb.meta_bwd,
           "bwd_stats": mb.meta_bwd}
    other = _build.load_from(csrc)
    if hasattr(other, "meta_block_widths"):
        other = Abi64(other)
    libs = {"this build": _build.load(), str(csrc): other}
    kept, all_same = _build._lib, True

    def run(lib, fn, a):
        _build._lib = lib
        out = fn(*a)
        return out if isinstance(out, tuple) else (out,)

    try:
        for kind, label, a in launches:
            fn = fns[kind]
            # the MLP weights rounded to bf16 and contiguous, as builds
            # before the kernels rounded them on load take them
            a = (*a[:2], *mb._weights(a[0], a[2:6]), *a[6:])
            outs, ms = {}, {}
            for name in (*libs, *libs):
                outs.setdefault(name, run(libs[name], fn, a))
                ms.setdefault(name, []).append(events_ms(lambda: fn(*a)))
            x, y = outs.values()
            off = sum(int((p != q).sum()) for p, q in zip(x, y))
            n = sum(p.numel() for p in x)
            if kind in ("agg", "bwd_agg", "bwd_stats"):
                all_same &= off == 0
            line = (f"{kind} ({label}): {off} of {n} elements other than "
                    f"{csrc}'s build")
            if kind == "taps":
                ref = training_taps(*a)
                line += "; elements other than the training plain a: " + \
                    ", ".join(f"{nm} {int((o[0] != ref).sum())}"
                              for nm, o in (("this build", x), (str(csrc), y)))
                del ref
            del outs
            print(line + "; events ms in turns " + "; ".join(
                f"{nm} " + " ".join(f"{v:.4f}" for v in t)
                for nm, t in ms.items()), flush=True)
    finally:
        _build._lib = kept
    return all_same


if __name__ == "__main__":
    main()
