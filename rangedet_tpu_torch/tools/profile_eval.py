"""Where the eval step's time goes on the card: the full-size serving path
of a recipe, seeded random weights, under ``torch.profiler``.

    python -m rangedet_tpu_torch.tools.profile_eval [--batch 4]
        [--out profile_b4.txt]

It drives the program's eval step (``infer.make_eval_step``) and reads
its ranges (``utils/spans.py``). Prints the wall time of the profiled
steps, the device time of the ``forward`` and ``postprocess`` ranges, of
the forward's Meta-Kernel block (``meta_block``), of the post-processing's
``topk``, ``decode`` and ``wnms``, the weighted NMS kernel's rounds a
row (a frame's class) in the last profiled step (``nms.take_rounds``),
the device busy share, and the kernels by total device time; writes the
full table to ``--out``. It profiles the recipe as it ships
(``use_pallas_meta``: the Meta-Kernel's taps from their kernel), then the
same step with the taps' plain version, for its range line.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

RECIPE = "rangedet_veh_wo_aug_4_18e"
ITERS = 5  # profiled steps, after 2 warm-up steps
SEED = 0
# every range of the eval step (their device copies are no kernels)
SPANS = ("forward", "postprocess", "meta_block", "topk", "decode", "wnms")


def _device_us(evt) -> float:
    return getattr(evt, "device_time_total", None) or getattr(
        evt, "cuda_time_total", 0.0)


def _self_device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0)


def range_device_ms(prof, names, iters):
    """Device ms per step of each named record_function range: the kernels
    (and copies) launched inside one of its host-side windows, on any
    thread (autograd launches the backward from its own), each kernel
    matched to its launch call by CUPTI's correlation id; a nested range's
    kernels count for the enclosing one as well. torch.profiler's own
    linking goes through the ops PyTorch launches from, so it credits no
    range with the port's kernels, which ctypes launches from a library
    with its own CUDA runtime."""
    from torch.autograd import DeviceType

    windows = {n: [] for n in names}
    launch, work = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() in windows:
                windows[e.name()].append((e.start_ns(), e.end_ns()))
            elif e.name().startswith("cu"):  # CUDA API calls: the launches
                launch[e.correlation_id()] = e.start_ns()
        elif e.name() not in windows and e.duration_ns() > 0:
            work.append((e.correlation_id(), e.duration_ns()))
    out = dict.fromkeys(names, 0.0)
    for corr, ns in work:
        t = launch.get(corr)
        for name, wins in windows.items():
            if t is not None and any(lo <= t < hi for lo, hi in wins):
                out[name] += ns / 1e6 / iters
    return out


def profile_step(cfg, batch_size):
    """Profile ITERS eval steps after 2 warm-up steps. Returns the wall ms
    per step, the busy device ms per step, the device ms of each range
    (and "rounds", the weighted NMS kernel's a row in the last profiled
    step) and the kernel events."""
    from rangedet_tpu_torch.data.synthetic import make_batch
    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.ops import nms

    dev = torch.device("cuda")
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    inputs = build_eval_inputs(
        make_batch(cfg, batch_size, seed=SEED, num_boxes=20), cfg, dev)

    step = make_eval_step(model, cfg)
    for _ in range(2):
        step(inputs)
    torch.cuda.synchronize()
    nms.take_rounds()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step(inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS

    ranges = range_device_ms(prof, SPANS, ITERS)
    ranges["rounds"] = nms.take_rounds()[-1].tolist()
    # kernels only: the ranges and the aten ops that launched the kernels
    # carry device time too
    kernels = [e for e in prof.key_averages() if e.key not in SPANS
               and str(e.device_type).endswith("CUDA")
               and _self_device_us(e) > 0]
    busy_ms = sum(_self_device_us(e) for e in kernels) / 1e3 / ITERS
    return wall_ms, busy_ms, ranges, kernels


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a CUDA card")

    from rangedet_tpu_torch.configs import load_config

    cfg = load_config(RECIPE, is_train=False)
    forms = [("kernel", cfg)] if cfg.use_pallas_meta else []
    forms.append(("plain", cfg.replace(use_pallas_meta=False)))
    name = torch.cuda.get_device_name(0)
    for i, (form, c) in enumerate(forms):
        wall_ms, busy_ms, ranges, kernels = profile_step(c, args.batch)
        print(f"profile_eval: {RECIPE} B={args.batch}, Meta-Kernel taps "
              f"{form}, on {name}: wall {wall_ms:.2f} ms/step, device busy "
              f"{busy_ms:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}%), "
              f"device ms by range: forward {ranges['forward']:.2f}, "
              f"postprocess {ranges['postprocess']:.2f} (topk "
              f"{ranges['topk']:.2f}, decode {ranges['decode']:.2f}, wnms "
              f"{ranges['wnms']:.2f}, rounds a row {ranges['rounds']}), "
              f"meta_block {ranges['meta_block']:.2f} (of the forward)")
        if i:  # the kernel table of the recipe's own step only
            continue
        kernels.sort(key=_self_device_us, reverse=True)
        lines = [f"{'device ms/step':>15} {'share':>6} {'calls/step':>10}  "
                 f"kernel"]
        for e in kernels:
            ms = _self_device_us(e) / 1e3 / ITERS
            lines.append(f"{ms:15.3f} {100 * ms / busy_ms:5.1f}% "
                         f"{e.count / ITERS:10.1f}  {e.key[:110]}")
        print("\n".join(lines[:26]))
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
