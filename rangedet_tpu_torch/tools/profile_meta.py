"""The Meta-Kernel kernels (csrc/meta_block.cu: meta_stats, meta_agg, the
block backward in both modes; csrc/meta_kernel.cu: the eval taps) on the
inputs one full-size B=2 train step and one B=4 and B=1 eval forward of
``rangedet_veh_wo_aug_4_18e`` give them (seeded random weights, synthetic
frames):

    python -m rangedet_tpu_torch.tools.profile_meta [--against DIR]

For each launch: the error against the plain version inside chip_smoke's
gates (for meta_agg also the count of bf16 outputs that differ from the
plain version's), whether two calls give the same bits, the time of one
call by CUDA events (10 back-to-back calls, host work included), its
device time by torch.profiler split into the main kernel and the
reduction of the block partials, the f32 operations it stands for
(meta_work) in TFLOP/s of the main kernel's device time, and two bounds:
f32 FFMA (meta_work at 67 TFLOP/s, or its bytes) and tensor cores
(tc_bound_ms). With ``--against DIR``, a ``csrc`` directory of another
build (e.g. a parent commit's, unpacked under the git-ignored build/),
meta_stats and the eval taps of both builds are compared bit for bit and
timed in turns. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
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
# kernel-name fragments of each launch's main kernel; the reduction of the
# block partials is reduce_blocks_kernel
MAIN = {"stats": "meta_stats_kernel", "agg": "meta_agg_kernel",
        "bwd_agg": "meta_bwd_kernel", "bwd_stats": "meta_bwd_kernel",
        "taps": "meta_taps_kernel"}


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
    whichever is longest; in ms."""
    ops, nbytes = meta_work(kind, B, H, W, C, Cm, Co)
    per = {"taps": 2 * C * Cm, "stats": 2 * C * Cm,
           "agg": 2 * C * Cm + 2 * C * Co,
           "bwd_agg": 6 * C * Cm + 4 * C * Co, "bwd_stats": 6 * C * Cm}[kind]
    mma = 9 * B * H * W * per
    return 1e3 * max(mma / PEAK_BF16, (ops - mma) / PEAK_F32,
                     nbytes / PEAK_BYTES)


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


def _rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp(min=1e-30)).item()


def _bf16_ok(y, ref):
    err = (y.float() - ref).abs()
    return bool((err <= REL_TOL * ref.abs() + MAX_TOL * ref.abs().max())
                .all() and y.float().isfinite().all())


def record_launches(dev):
    """The Meta-Kernel launches of one B=2 train step (forward and
    backward) and of one B=4 and one B=1 eval forward: [(work kind,
    label, args)]."""
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

    cfg = load_config(RECIPE, is_train=True)
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    model = model.to(dev).train()
    batch = batch_to_device(make_batch(cfg, 2, seed=SEED, num_boxes=20), dev)
    with mock.patch.multiple(mb, **{n: keep(n) for n in real}):
        targets = build_train_targets(batch, cfg)
        cls, reg = model(batch["input_data"], batch["coord"])
        compute_losses(cls, reg, targets, cfg)[0].backward()
    ecfg = load_config(RECIPE, is_train=False)
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
        off = int((got != mb.meta_agg_plain(*args)).sum())
    elif kind == "taps":
        fn = taps.meta_kernel_taps
        got = fn(*args)
        ok = _bf16_ok(got, taps.meta_kernel_taps_plain(
            *(a.to(feat.dtype).float() for a in args)))
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
                tc=tc_bound_ms(kind, B, H, W, C, Cm, Co))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--against", type=Path, default=None,
                   help="a csrc directory of another build to hold "
                        "meta_stats and the eval taps against")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_meta needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"profile_meta on {smi}", flush=True)
    dev = torch.device("cuda")
    failed = False
    sums = {}
    launches = record_launches(dev)
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
        off = ("" if m["off"] is None else f", {m['off']} bf16 outputs "
               "other than the plain version's")
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


def against(csrc, launches):
    """meta_stats and the eval taps of this build and of the build of
    ``csrc``, on the same inputs: bit-equal outputs, events ms in turns.
    True when every output is bit-equal."""
    from ..ops import meta_block as mb
    from ..ops import meta_kernel as taps

    libs = {"this build": _build.load(), str(csrc): _build.load_from(csrc)}
    kept, all_same = _build._lib, True
    try:
        for kind, label, a in launches:
            if kind not in ("stats", "taps"):
                continue
            fn = mb.meta_stats if kind == "stats" else taps.meta_kernel_taps
            outs, ms = {}, {}
            for name in (*libs, *libs):
                _build._lib = libs[name]
                outs.setdefault(name, fn(*a))
                ms.setdefault(name, []).append(events_ms(lambda: fn(*a)))
            x, y = (o if isinstance(o, tuple) else (o,)
                    for o in outs.values())
            same = all(torch.equal(p, q) for p, q in zip(x, y))
            all_same &= same
            print(f"{kind} ({label}): bit-equal to {csrc}'s build {same}; "
                  "events ms in turns " + "; ".join(
                      f"{n} " + " ".join(f"{v:.4f}" for v in t)
                      for n, t in ms.items()), flush=True)
    finally:
        _build._lib = kept
    return all_same


if __name__ == "__main__":
    main()
