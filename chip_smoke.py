#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, one line of output each (or a table), failing on the first error:

1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   the build of the hand-written kernels from ``rangedet_tpu_torch/csrc``;
2. the conv3x3 kernel against its plain PyTorch version on the card, at
   every (Ci, Co, W, stride, ingest) the B=1 forward launches and at the
   largest shape for B=4: max error and ms of both;
3. the full serving path of ``rangedet_veh_wo_aug_4_18e`` at 64x2656 with
   seeded random weights, at B=4 and B=1: the kernel's launch count per
   forward, finite outputs, logits and deltas against the plain path, the
   median eval-step time, its weighted-NMS share and the peak memory;
4. ``python -m rangedet_tpu_torch.tools.test`` on 2 synthetic frames.

It prints a JSON line of the kernels, then as its last line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero.
"""
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

RECIPE = "rangedet_veh_wo_aug_4_18e"
SEED = 0
# |y - ref| <= REL_TOL * |ref| + MAX_TOL * max|ref|, ref in f32 from the same
# bf16 operands: the kernel accumulates in f32 and rounds once to bf16
REL_TOL = 2.0 ** -6
MAX_TOL = 1e-3
# kernel path vs plain path, whole model: max|a - b| / max|b| per output
MODEL_TOL = 5e-2


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _time_ms(fn, iters=10, warmup=2):
    """Mean ms of fn() over iters launches, by CUDA events."""
    import torch

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


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA card only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rangedet_tpu.data.synthetic import make_batch
    from rangedet_tpu_torch import _build
    from rangedet_tpu_torch.configs import load_config
    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.models.dla_backbone import (
        DEFAULT_META_UNITS,
        DEFAULT_NUM_BLOCK,
    )
    from rangedet_tpu_torch.models.detector import run_inference
    from rangedet_tpu_torch.ops import conv3x3, nms
    from rangedet_tpu_torch.tools import test as test_cli

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
          f"(nvcc {_build.build_seconds:.2f} s) -> {_build.library_path()}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1] ptxas: {line.strip()}")

    cfg = load_config(RECIPE, is_train=False)
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    eval_step = make_eval_step(model, cfg)

    # ------------------------------------------------------------ phase 2
    # the conv shapes of the path, read off one B=1 forward
    shapes = {}
    real_conv = conv3x3.conv3x3_bhcw

    def record(x, w, scale=None, bias=None, stride_w=1):
        key = (x.shape[2], w.shape[3], x.shape[3], stride_w,
               scale is not None)
        shapes[key] = shapes.get(key, 0) + 1
        return real_conv(x, w, scale, bias, stride_w)

    inputs1 = build_eval_inputs(make_batch(cfg, 1, seed=SEED, num_boxes=20),
                                cfg, dev)
    with mock.patch.object(conv3x3, "conv3x3_bhcw", record), \
            torch.inference_mode():
        model(inputs1["input_data"], inputs1["coord"])
    H = cfg.pad_field[0]
    largest = max(shapes, key=lambda k: k[0] * k[1] * k[2] / k[3])
    cases = [(1, k) for k in sorted(shapes)] + [(4, largest)]
    print(f"[2] {len(shapes)} distinct conv shapes in the B=1 forward, "
          f"{sum(shapes.values())} launches; plus the largest at B=4")
    print("[2]  B    Ci    Co     W s ingest n/fwd  max_abs_err    tol_ok"
          "  kernel_ms   plain_ms cudnn_bf16_ms")
    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    fwd_ms = fwd_plain_ms = 0.0
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
        err = (y.float() - ref).abs()
        ok = bool((err <= REL_TOL * ref.abs()
                   + MAX_TOL * ref.abs().max()).all())
        if not (ok and torch.isfinite(y).all()):
            raise SystemExit(f"[2] conv3x3 kernel disagrees at B={B} "
                             f"Ci={Ci} Co={Co} W={W} s={s} ingest={ingest}: "
                             f"max err {err.max().item()}")
        k_ms = _time_ms(lambda: conv3x3.conv3x3_bhcw(x, w, sc, bi, s))
        p_ms = _time_ms(lambda: conv3x3.conv3x3_bhcw_plain(x, w, sc, bi, s))
        # for scale only, not a reference: cuDNN's bf16 conv, no ingest
        xn = x.permute(0, 2, 1, 3).contiguous(
            memory_format=torch.channels_last)
        wn = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        c_ms = _time_ms(lambda: torch.nn.functional.conv2d(
            xn, wn, stride=(1, s), padding=1))
        e = err.max().item()
        max_err = max(max_err, e)
        n = shapes[(Ci, Co, W, s, ingest)] if B == 1 else 0
        fwd_ms += n * k_ms
        fwd_plain_ms += n * p_ms
        if B == 4:
            big_ms, big_plain_ms = k_ms, p_ms
        print(f"[2] {B:2d} {Ci:5d} {Co:5d} {W:5d} {s} {int(ingest):6d} "
              f"{n:5d} {e:12.6g} {str(ok):>9} {k_ms:10.4f} {p_ms:10.4f} "
              f"{c_ms:13.4f}")
    print(f"[2] conv3x3 per B=1 forward (sum over launches): kernel "
          f"{fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms; largest shape at "
          f"B=4: kernel {big_ms:.4f} ms, plain {big_plain_ms:.4f} ms")

    # ------------------------------------------------------------ phase 3
    n_meta = len(DEFAULT_META_UNITS if cfg.meta_units is None
                 else cfg.meta_units)
    n_blocks = sum((cfg.num_block or DEFAULT_NUM_BLOCK).values())
    n_levels = len(cfg.fpn_strides)
    expected = (2 * n_blocks - n_meta + 4
                + n_levels * (cfg.cls_conv_layers + cfg.reg_conv_layers))
    print(f"[3] expected conv3x3 launches per forward: 2*{n_blocks} block "
          f"convs - {n_meta} Meta-Kernel conv1 + 4 agg deconvs + "
          f"{n_levels}*({cfg.cls_conv_layers}+{cfg.reg_conv_layers}) head "
          f"= {expected}")
    step_launches = None
    for B in (4, 1):
        inputs = build_eval_inputs(
            make_batch(cfg, B, seed=SEED, num_boxes=20), cfg, dev)
        torch.cuda.synchronize()
        conv3x3.LAUNCHES = 0
        out = eval_step(inputs)
        torch.cuda.synchronize()
        launches = conv3x3.LAUNCHES
        if launches != expected:
            raise SystemExit(f"[3] B={B}: {launches} conv3x3 launches, "
                             f"expected {expected}")
        step_launches = launches
        res = out["veh"]
        boxes, valid = res["boxes"], res["valid"]
        if not (torch.isfinite(boxes[valid]).all()
                and tuple(boxes.shape) == (B, cfg.post_nms_top_n["veh"], 8)):
            raise SystemExit(f"[3] B={B}: non-finite or misshapen boxes")

        with torch.inference_mode():
            got = model(inputs["input_data"], inputs["coord"])
            with mock.patch.object(conv3x3, "conv3x3_bhcw",
                                   conv3x3.conv3x3_bhcw_plain):
                want = model(inputs["input_data"], inputs["coord"])
        rels = []
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            if not torch.isfinite(a).all():
                raise SystemExit(f"[3] B={B}: non-finite logits/deltas")
            rels.append(((a - b).abs().max() / b.abs().max()).item())
        rel = max(rels)
        print(f"[3] B={B}: kernel vs plain path, max|a-b|/max|b| per output "
              f"(logits by level, then deltas): "
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
        print(f"[3] B={B}: {launches} conv3x3 launches/forward; outputs "
              f"finite; kernel vs plain path max rel err {rel:.4g} "
              f"(bound {MODEL_TOL}); eval step median {step_ms:.2f} ms "
              f"(forward {fwd_ms_b:.2f} ms, WNMS {wnms_ms:.2f} ms = "
              f"{100 * wnms_ms / step_ms:.1f}%); {n_valid} valid candidates, "
              f"{int(valid.sum())} boxes, truncated "
              f"{res['truncated'].tolist()}; peak memory {peak:.2f} GiB")

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
    print(f"[4] tools.test: 2 frames, {n_det} detections, pickle read back")

    print(json.dumps({"kernels": [{
        "name": "conv3x3_bhcw",
        "route": "cuda",
        "source": "rangedet_tpu_torch/csrc/conv3x3_bhcw.cu",
        "replaces": "rangedet_tpu/ops/conv_pallas.py:252",
        "launches": step_launches,
        "max_abs_err": max_err,
        "ms": fwd_ms,
        "plain_ms": fwd_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
