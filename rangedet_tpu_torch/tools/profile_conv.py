"""The conv3x3 forward/dgrad kernel (csrc/conv3x3_bhcw.cu) at every
forward and dgrad shape of one full-size B=2 train step of
``rangedet_veh_wo_aug_4_18e`` and of its B=1 eval forward:

    python -m rangedet_tpu_torch.tools.profile_conv [--paths serve train dgrad]

For each shape: the largest error against the plain version and whether it
is inside the bf16 gate of chip_smoke (and the f32 sums inside theirs),
whether two calls give the same bits, the time of one call by CUDA events
(10 back-to-back calls, host work included), its device time split by
torch.profiler into the prologue (ingest_t), the GEMM and the reduction of
the sums, the GEMM's TFLOP/s and share of the bound, and cuDNN's
``conv2d`` / ``conv2d_input`` on the same inputs; then the sums weighted
by the launches per step or forward (the counts chip_smoke [2] and [5]
read off the model). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from ..ops import conv3x3 as conv
from .profile_wgrad import events_ms

H = 64
PEAK_BF16 = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
# (Ci, Co, W, stride, ingest, launches per B=1 eval forward)
SERVE_SHAPES = [
    (8, 64, 2656, 1, False, 1), (64, 64, 1328, 1, False, 3),
    (64, 64, 1328, 1, True, 3), (64, 64, 2656, 1, False, 6),
    (64, 64, 2656, 1, True, 5), (64, 64, 2656, 2, True, 1),
    (64, 128, 1328, 1, False, 4), (72, 128, 2656, 1, False, 2),
    (128, 128, 166, 1, False, 4), (128, 128, 166, 1, True, 4),
    (128, 128, 332, 1, False, 5), (128, 128, 332, 1, True, 4),
    (128, 128, 332, 2, True, 1), (128, 128, 664, 1, False, 8),
    (128, 128, 664, 1, True, 10), (128, 128, 664, 2, True, 1),
    (128, 128, 1328, 1, True, 6), (128, 128, 1328, 2, True, 1),
    (128, 128, 2656, 1, True, 6), (128, 256, 664, 1, False, 1),
    (128, 512, 166, 1, False, 1),
]
# (Ci, Co, W, stride, ingest, stats, launches per B=2 train step)
TRAIN_SHAPES = [
    (8, 64, 2656, 1, False, True, 1), (64, 64, 1328, 1, False, True, 3),
    (64, 64, 1328, 1, True, True, 3), (64, 64, 2656, 1, False, True, 6),
    (64, 64, 2656, 1, True, True, 5), (64, 64, 2656, 2, True, True, 1),
    (64, 128, 1328, 1, False, False, 1), (64, 128, 1328, 1, False, True, 3),
    (72, 128, 2656, 1, False, True, 2), (128, 128, 166, 1, False, True, 4),
    (128, 128, 166, 1, True, True, 4), (128, 128, 332, 1, False, True, 5),
    (128, 128, 332, 1, True, True, 4), (128, 128, 332, 2, True, True, 1),
    (128, 128, 664, 1, False, False, 1), (128, 128, 664, 1, False, True, 7),
    (128, 128, 664, 1, True, True, 10), (128, 128, 664, 2, True, True, 1),
    (128, 128, 1328, 1, True, True, 6), (128, 128, 1328, 2, True, True, 1),
    (128, 128, 2656, 1, True, True, 6), (128, 256, 664, 1, False, False, 1),
    (128, 512, 166, 1, False, False, 1),
]
# (Cgy, Cdx, W, cot, affine, launches per B=2 train step): stride-2 convs
# in their phase-packed form (Cdx = 2 Ci, W/2), the deconvs with s*Co
DGRAD_SHAPES = [
    (64, 64, 1328, True, False, 3), (64, 64, 1328, True, True, 3),
    (64, 64, 2656, True, False, 6), (64, 64, 2656, True, True, 5),
    (64, 128, 1328, True, True, 1), (128, 64, 1328, False, False, 1),
    (128, 64, 1328, True, False, 3), (128, 72, 2656, True, False, 2),
    (128, 128, 166, True, False, 4), (128, 128, 166, True, True, 4),
    (128, 128, 332, True, False, 5), (128, 128, 332, True, True, 4),
    (128, 128, 664, False, False, 1), (128, 128, 664, True, False, 7),
    (128, 128, 664, True, True, 10), (128, 128, 1328, True, True, 6),
    (128, 128, 2656, True, True, 6), (128, 256, 166, True, True, 1),
    (128, 256, 332, True, True, 1), (128, 256, 664, True, True, 1),
    (256, 128, 664, False, False, 1), (512, 128, 166, False, False, 1),
]
# |y - ref| <= REL_TOL |ref| + MAX_TOL max|ref|; f32 sums within SUM_TOL
# of max|ref| (chip_smoke's gates)
REL_TOL, MAX_TOL, SUM_TOL = 2.0 ** -6, 1e-3, 1e-3
PARTS = {"ingest_t_kernel": "prologue", "conv3x3_gemm_kernel": "gemm",
         "reduce_rows_kernel": "reduce"}


def device_ms(fn, iters=3, tries=3):
    """Device ms per call by kernel: {"prologue", "gemm", "reduce"} under
    torch.profiler; None when ``tries`` profiled runs saw no GEMM."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = dict.fromkeys(PARTS.values(), 0.0)
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0.0)
            for name, part in PARTS.items():
                if name in e.key:
                    split[part] += us / iters / 1e3
        if split["gemm"] > 0:
            return split
    return None


def bound_ms(flops, nbytes):
    return 1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def _bf16_err(y, ref):
    err = (y.float() - ref).abs()
    ok = bool((err <= REL_TOL * ref.abs() + MAX_TOL * ref.abs().max()).all())
    return err.max().item(), ok and bool(y.float().isfinite().all())


def _rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp(min=1e-30)).item()


def _channels_last(t):
    return t.permute(0, 2, 1, 3).contiguous(memory_format=torch.channels_last)


def case(path, row, g, dev):
    """One shape: (n, dict of measurements)."""
    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=g)

    F = torch.nn.functional
    if path == "dgrad":
        Cg, Cx, W, cot, aff, n = row
        B = 2
        gy = rn(B, H, Cg, W).bfloat16()
        w = (rn(3, 3, Cx, Cg) / (3.0 * Cx ** 0.5)).bfloat16()
        cots = ((rn(B, H, Cg, W).bfloat16(), rn(Cg, scale=0.1),
                 rn(Cg, scale=0.05)) if cot else None)
        affs = ((rn(B, H, Cx, W).bfloat16(), 1 + 0.3 * rn(Cx), 0.2 * rn(Cx))
                if aff else None)

        def call():
            return conv.conv3x3_dgrad(gy, w, cots, affs)

        ref = conv.conv3x3_dgrad_plain(gy, w, cots, affs,
                                       out_dtype=torch.float32)
        gn, wn = _channels_last(gy), w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def lib():
            return torch.nn.grad.conv2d_input((B, Cx, H, W), wn, gn,
                                              padding=1)

        flops = 2 * B * H * W * Cg * Cx * 9
        nbytes = 2 * (B * H * (Cg + Cx) * W + 9 * Cg * Cx
                      + (B * H * Cg * W if cot else 0)
                      + (B * H * Cx * W if aff else 0))
        sums = aff
        label = (f"Cgy {Cg:3d} Cdx {Cx:3d} W {W:4d} cot {int(cot)} "
                 f"aff {int(aff)}")
    else:
        if path == "serve":
            (Ci, Co, W, s, ingest, n), stats, B = row, False, 1
        else:
            Ci, Co, W, s, ingest, stats, n = row
            B = 2
        x = rn(B, H, Ci, W).bfloat16()
        w = (rn(3, 3, Ci, Co) / (3.0 * Ci ** 0.5)).bfloat16()
        sc, bi = (1 + 0.3 * rn(Ci), 0.2 * rn(Ci)) if ingest else (None, None)

        def call():
            return conv.conv3x3_bhcw(x, w, sc, bi, s, stats)

        ref = conv.conv3x3_bhcw_plain(x, w, sc, bi, s,
                                      out_dtype=torch.float32)
        xn, wn = _channels_last(x), w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def lib():
            return F.conv2d(xn, wn, stride=(1, s), padding=1)

        Wo = W // s
        flops = 2 * B * H * Wo * Co * Ci * 9
        nbytes = 2 * (B * H * Ci * W + 9 * Ci * Co + B * H * Co * Wo)
        sums = stats
        label = (f"Ci {Ci:3d} Co {Co:3d} W {W:4d} s {s} ingest {int(ingest)}"
                 f" stats {int(stats)}")
    out = call()
    again = call()
    torch.cuda.synchronize()
    y = out[0] if sums else out
    same = torch.equal(y, again[0] if sums else again)
    err, ok = _bf16_err(y, ref[0] if path == "dgrad" and sums else ref)
    if sums and path == "dgrad":
        ok &= max(_rel(out[1], ref[1]), _rel(out[2], ref[2])) <= SUM_TOL
    elif sums:
        yd = y.double()
        ok &= max(_rel(out[1], yd.sum((0, 1, 3))),
                  _rel(out[2], (yd * yd).sum((0, 1, 3)))) <= SUM_TOL
    return n, dict(label=label, err=err, ok=ok, same=same,
                   events=events_ms(call), split=device_ms(call),
                   cudnn=events_ms(lib), flops=flops,
                   bound=bound_ms(flops, nbytes))


def profile_path(path, seed=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = {"serve": SERVE_SHAPES, "train": TRAIN_SHAPES,
            "dgrad": DGRAD_SHAPES}[path]
    tot = dict(n=0, events=0.0, cudnn=0.0, bound=0.0, flops=0.0,
               measured=0, prologue=0.0, gemm=0.0, reduce=0.0, ok=True,
               same=True)
    for row in rows:
        n, m = case(path, row, g, dev)
        tot["n"] += n
        tot["ok"] &= m["ok"]
        tot["same"] &= m["same"]
        for k in ("events", "cudnn", "bound", "flops"):
            tot[k] += n * m[k]
        detail = "device time not measured"
        if m["split"] is not None:
            sp = m["split"]
            tot["measured"] += n
            for k in ("prologue", "gemm", "reduce"):
                tot[k] += n * sp[k]
            detail = (f"device prologue {sp['prologue']:.4f} + GEMM "
                      f"{sp['gemm']:.4f} + reduce {sp['reduce']:.4f} ms "
                      f"(GEMM {m['flops'] / sp['gemm'] / 1e9:.0f} TFLOP/s, "
                      f"{m['bound'] / sp['gemm']:.1%} of the bound)")
        print(f"{path} {m['label']} x{n:2d}: max err {m['err']:.4g} "
              f"gate {'ok' if m['ok'] else 'FAILED'}, bit-equal repeat "
              f"{m['same']}; events {m['events']:.4f} ms; {detail}; cuDNN "
              f"{m['cudnn']:.4f} ms; bound {m['bound']:.4f} ms", flush=True)
    return tot


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--paths", nargs="+", default=["serve", "train", "dgrad"],
                   choices=["serve", "train", "dgrad"])
    args = p.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"profile_conv on {smi}", flush=True)
    failed = False
    for path in args.paths:
        t = profile_path(path)
        dev = t["prologue"] + t["gemm"] + t["reduce"]
        print(f"== {path}, summed over the {t['n']} launches of "
              f"{'a B=1 forward' if path == 'serve' else 'a B=2 step'}: "
              f"events {t['events']:.3f} ms, cuDNN {t['cudnn']:.3f} ms, "
              f"events / cuDNN {t['events'] / t['cudnn']:.2f}, bound "
              f"{t['bound']:.3f} ms; device {dev:.3f} ms over "
              f"{t['measured']} of them (prologue {t['prologue']:.3f}, GEMM "
              f"{t['gemm']:.3f}, reduce {t['reduce']:.3f}; GEMM "
              f"{t['flops'] / max(t['gemm'], 1e-9) / 1e9:.0f} TFLOP/s); all "
              f"within the gates {t['ok']}, repeats bit-equal {t['same']}",
              flush=True)
        failed |= not (t["ok"] and t["same"])
    if failed:
        raise SystemExit("profile_conv: a shape failed its gate or repeat")


if __name__ == "__main__":
    main()
