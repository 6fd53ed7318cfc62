"""The conv3x3 weight-gradient kernel (csrc/conv3x3_wgrad.cu) at the
weight-gradient shapes of one full-size B=2 train step of
``rangedet_veh_wo_aug_4_18e``:

    python -m rangedet_tpu_torch.tools.profile_wgrad [--stages 4 1]

For each shape: max|kernel - plain| / max|plain|, whether two calls give
the same bits, the time of one call by CUDA events (10 back-to-back calls,
host work included), its device time split by torch.profiler into the
prologue kernels and the GEMM with its reduction, the GEMM's TFLOP/s, and
cuDNN's ``conv2d_weight`` on the same inputs; then the sums weighted by
the launches per step (the counts chip_smoke [5] reads off a step).
``--stages`` times the kernel as built with each depth of its
shared-memory ring (4 as shipped; other depths are built from a copy of
csrc/ under build/). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess

import torch

from .. import _build
from ..ops import conv3x3 as conv

# (Ci, Co, W, ingest, cot, launches per step) at B=2, H=64
STEP_SHAPES = [
    (8, 64, 2656, False, True, 1), (64, 64, 1328, False, True, 3),
    (64, 64, 1328, True, True, 3), (64, 64, 2656, False, True, 6),
    (64, 64, 2656, True, True, 5), (64, 128, 1328, False, False, 1),
    (64, 128, 1328, False, True, 3), (72, 128, 2656, False, True, 2),
    (128, 64, 1328, True, True, 1), (128, 128, 166, False, True, 4),
    (128, 128, 166, True, True, 4), (128, 128, 332, False, True, 5),
    (128, 128, 332, True, True, 4), (128, 128, 664, False, False, 1),
    (128, 128, 664, False, True, 7), (128, 128, 664, True, True, 10),
    (128, 128, 1328, True, True, 6), (128, 128, 2656, True, True, 6),
    (128, 256, 664, False, False, 1), (128, 512, 166, False, False, 1),
    (256, 128, 166, True, True, 1), (256, 128, 332, True, True, 1),
    (256, 128, 664, True, True, 1),
]
STAGES_LINE = "constexpr int STAGES = 4;"


def events_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=3, tries=3):
    """Device ms per call: (the prologue kernels, the GEMM and the
    reduction), by kernel name under torch.profiler; None when ``tries``
    profiler sessions saw none of the kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        pro = gemm = 0.0
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0.0)
            if "wgrad_ingest_kernel" in e.key or "ingest_t_kernel" in e.key:
                pro += us
            elif "conv3x3_wgrad_kernel" in e.key or "reduce_splits" in e.key:
                gemm += us
        if gemm > 0:
            return pro / iters / 1e3, gemm / iters / 1e3
    return None


def variant_library(stages: int):
    """The kernels built with a ring of ``stages`` stages."""
    if stages == 4:
        return _build.load()
    src = _build.BUILD_DIR.parent / "wgrad_variants" / f"stages{stages}"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    cu = src / "conv3x3_wgrad.cu"
    text = cu.read_text()
    if STAGES_LINE not in text:
        raise RuntimeError(f"{cu} has no line {STAGES_LINE!r}")
    cu.write_text(text.replace(STAGES_LINE,
                               f"constexpr int STAGES = {stages};"))
    return _build.load_from(src)


def profile_shapes(stages: int, seed: int = 0):
    dev = torch.device("cuda")
    lib = variant_library(stages)
    kept, _build._lib = _build._lib, lib
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=g)

    tot = dict(events=0.0, prologue=0.0, gemm=0.0, cudnn=0.0, n=0,
               measured=0)
    try:
        for Ci, Co, W, ingest, cot, n in STEP_SHAPES:
            B, H = 2, 64
            x, gy = rn(B, H, Ci, W).bfloat16(), rn(B, H, Co, W).bfloat16()
            sc, bi = ((1 + 0.3 * rn(Ci), 0.2 * rn(Ci)) if ingest
                      else (None, None))
            cots = ((rn(B, H, Co, W).bfloat16(), rn(Co, scale=0.1),
                     rn(Co, scale=0.05)) if cot else None)

            def call():
                return conv.conv3x3_wgrad(x, gy, sc, bi, cots)

            dw = call()
            same = torch.equal(dw, call())
            ref = conv.conv3x3_wgrad_plain(x, gy, sc, bi, cots)
            rel = ((dw.double() - ref.double()).abs().max()
                   / ref.double().abs().max()).item()
            ev = events_ms(call)
            split = device_ms(call)
            xn = x.permute(0, 2, 1, 3).contiguous(
                memory_format=torch.channels_last)
            gn = gy.permute(0, 2, 1, 3).contiguous(
                memory_format=torch.channels_last)
            cu = events_ms(lambda: torch.nn.grad.conv2d_weight(
                xn, (Co, Ci, 3, 3), gn, padding=1))
            flops = 2 * B * H * W * Ci * Co * 9
            tot["events"] += n * ev
            tot["cudnn"] += n * cu
            tot["n"] += n
            if split is None:
                detail = "device time not measured"
            else:
                pro, gemm = split
                tot["prologue"] += n * pro
                tot["gemm"] += n * gemm
                tot["measured"] += n
                detail = (f"device prologue {pro:.4f} + GEMM {gemm:.4f} ms "
                          f"({flops / gemm / 1e9:.0f} TFLOP/s)")
            print(f"Ci {Ci:3d} Co {Co:3d} W {W:4d} ingest {int(ingest)} cot "
                  f"{int(cot)} x{n:2d}: rel err {rel:.2e}, bit-equal "
                  f"{same}; events {ev:.4f} ms; {detail}; cuDNN {cu:.4f} ms",
                  flush=True)
    finally:
        _build._lib = kept
    return tot


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stages", type=int, nargs="+", default=[4])
    args = p.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"profile_wgrad on {smi}", flush=True)
    for stages in args.stages:
        print(f"== ring of {stages} stages", flush=True)
        t = profile_shapes(stages)
        total = t["prologue"] + t["gemm"]
        print(f"== {stages} stages, summed over the {t['n']} launches of a "
              f"step: events {t['events']:.3f} ms, cuDNN {t['cudnn']:.3f} "
              f"ms, events / cuDNN {t['events'] / t['cudnn']:.2f}; device "
              f"{total:.3f} ms over {t['measured']} of them (prologue "
              f"{t['prologue']:.3f}, GEMM + reduction {t['gemm']:.3f})",
              flush=True)


if __name__ == "__main__":
    main()
