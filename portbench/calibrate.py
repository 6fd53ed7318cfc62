"""The readings the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 -m portbench.calibrate --workload <cell> --seeds <a,b,...> \
        [--control-seeds <...>] [--faults <...>] [--fault-seeds <...>] \
        [--witness-seeds <...>] [--seconds 4]

* the program: a run of the cell (``run.run_cell``, a short window) on
  each of ``--seeds``, its numbers compared;
* the control on each of ``--control-seeds``: the reference computed in
  fp8 (``reference.precision.fp8_cast``) in the program's place, its
  numbers against the f32 reference's by the same comparison (training:
  the first three steps; eval: the forward on the window's sampled
  batches); and beside it the reference computed in bf16, the precision
  the configurations state, a witness of what that rounding alone reads;
* each fault of ``portbench.faults`` planted in the timed path, on each
  of ``--fault-seeds`` (by default the control seeds);
* on each of ``--witness-seeds`` (training), the bf16 witness through the
  first three steps, its gaps read leaf by leaf as the program's are
  (``reading`` "witness_bf16"; a witness that does not fit on the card
  reads "oom").

One JSON line a reading: {"kind", "seed", "numbers", "correct"}.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

import torch

from . import run
from .check import (CASTS, compare_boxes, forward_gap, forward_rms_gap,
                    reference_boxes, reference_forward, reference_train,
                    stage_gap, train_gaps, train_numbers)
from .reference.train import first_forward
from .traffic.frames import make_pool
from .weights import model_weights


def summary(detail) -> dict:
    """The per-step loss gaps, and per kind of leaf gap the median and the
    five worst leaves."""
    if detail is None:
        return {}
    out = {"losses": detail["losses"], "forward1": detail["forward1"],
           "forward1_max": detail["forward1_max"],
           "stages1": detail["stages1"]}
    for kind in ("grad", "update"):
        gaps = detail[kind]
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
        out[kind] = {"median": statistics.median(gaps.values()),
                     "worst": worst}
    return out


def reference_numbers(workload: str, seed: int, precision: str, dev=None,
                      bench_path=run.ROOT / "BENCHMARK.json", overrides=None):
    """The reference at ``precision`` in the program's place: (numbers,
    detail) against the f32 reference. In training, the first step's
    numbers (the first forward, its stages, its loss); the limits of the
    gradients' and updates' gaps take their upper readings from the
    faults."""
    _, cell, config, traffic = run.load_spec(workload, bench_path)
    c = dict(config["config"], **(overrides or {}))
    dev = dev or torch.device("cuda", 0)
    data = run.content_seed(seed, traffic)
    P0 = model_weights(c, data, dev)
    if traffic["mode"] == "train":
        pool = [run.to_device(b, dev) for b in make_pool(
            data, run.global_traffic(traffic, cell["chips"]), c,
            batches=range(3))]
        spe = config["assumed"]["steps_per_epoch"]
        ref = run.host_readings(reference_train(P0, c, spe, pool[:3]))
        # the lower precision's first forward (a backward in fp8 needs
        # twice the f32 one's memory), its stages in the program's layout
        low = first_forward(P0, c, pool[0], CASTS[precision])
        low = {"losses": low["losses"],
               "forward1": tuple([t.cpu() for t in o]
                                 for o in low["forward1"]),
               "stages1": {k: v.permute(0, 2, 1, 3).cpu()
                           for k, v in low["stages1"].items()}}
        numbers = {"res1_gap": stage_gap(low, ref, "res1"),
                   "forward1_gap": forward_rms_gap(low["forward1"],
                                                   ref["forward1"]),
                   "loss1_gap": abs(low["losses"][0] - ref["losses"][0])
                   / abs(ref["losses"][0])}
        return numbers, None
    pool = [run.to_device(b, dev) for b in make_pool(data, traffic, c)]
    sample, order = run.plan(seed, traffic)
    batches = sorted({order[(traffic["warmup_steps"] + i)
                            % traffic["pool_batches"]] for i in sample})
    numbers = {"forward_gap": 0.0, "boxes_mismatch": 0.0, "boxes_gap": 0.0}
    for j in batches:
        ref = reference_forward(P0, c, pool[j])
        numbers["forward_gap"] = max(
            numbers["forward_gap"],
            forward_gap(reference_forward(P0, c, pool[j], precision), ref))
        # the post-processing's control: the same stage computed in bf16,
        # below the f32 it runs in, on the reference's logits and deltas
        bx = compare_boxes(reference_boxes(ref, pool[j], c, "bf16"),
                           reference_boxes(ref, pool[j], c))
        numbers["boxes_mismatch"] += bx["boxes_mismatch"]
        numbers["boxes_gap"] = max(numbers["boxes_gap"], bx["boxes_gap"])
    return numbers, None


def witness_numbers(workload: str, seed: int, dev=None, overrides=None):
    """The reference with its operands and gradients rounded through bf16
    (the precision the configurations state) in the program's place
    through the first three steps: (numbers, detail) against the f32
    reference, every leaf's gap read as the program's are."""
    _, cell, config, traffic = run.load_spec(workload)
    c = dict(config["config"], **(overrides or {}))
    dev = dev or torch.device("cuda", 0)
    data = run.content_seed(seed, traffic)
    P0 = model_weights(c, data, dev)
    pool = [run.to_device(b, dev) for b in make_pool(
        data, run.global_traffic(traffic, cell["chips"]), c,
        batches=range(3))]
    spe = config["assumed"]["steps_per_epoch"]
    ref = run.host_readings(reference_train(P0, c, spe, pool))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    low = run.host_readings(reference_train(P0, c, spe, pool, "bf16"))
    low["stages1"] = {k: v.permute(0, 2, 1, 3)
                      for k, v in low["stages1"].items()}
    detail = train_gaps(low, ref, {k: v.cpu() for k, v in P0.items()})
    return train_numbers(detail), detail


def control_numbers(workload: str, seed: int) -> dict:
    """The control: the reference in fp8 in the program's place."""
    return reference_numbers(workload, seed, "fp8")[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    _, _, config, traffic = run.load_spec(a.workload)
    limits = config["limits"][traffic["mode"]]

    def emit(kind, seed, numbers, detail=None, timings=None):
        ok = all(v <= limits[k] for k, v in numbers.items())
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                          "correct": ok, "detail": summary(detail),
                          "timings": timings}), flush=True)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    for s in seeds(a.seeds):
        out = run.run_cell(a.workload, s, a.seconds, False,
                           t_start=time.perf_counter())
        emit("program", s, {k: v for k, (v, _) in out["checks"].items()},
             out["detail"], out["timings"])
        gc.collect()
        torch.cuda.empty_cache()
    for s in seeds(a.control_seeds):
        for precision in ("fp8", "bf16"):
            emit(f"reference_{precision}", s,
                 *reference_numbers(a.workload, s, precision))
            gc.collect()
            torch.cuda.empty_cache()
    for s in seeds(a.fault_seeds or a.control_seeds):
        for name in [f for f in a.faults.split(",") if f]:
            out = run.run_cell(a.workload, s, a.seconds, False,
                               fault=name,
                               t_start=time.perf_counter())
            emit(f"fault_{name}", s,
                 {k: v for k, (v, _) in out["checks"].items()})
            gc.collect()
            torch.cuda.empty_cache()
    for s in seeds(a.witness_seeds):
        try:
            emit("witness_bf16", s, *witness_numbers(a.workload, s))
        except torch.cuda.OutOfMemoryError:
            print(json.dumps({"kind": "witness_bf16", "seed": s,
                              "oom": True}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
