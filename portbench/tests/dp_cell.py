"""The data-parallel cell ``veh.train.dp4`` added as data to a copy of the
benchmark's files, as a later change would add it to ``BENCHMARK.json``
(``PERF.md`` keeps it out until its rate is steady), and a tiny run of it
over two gloo ranks on the CPU."""
import json
import shutil
from pathlib import Path

from portbench import run

from tiny import TINY, TINY_TRAFFIC

CELL = {"name": "veh.train.dp4", "config": "rangedet_veh_wo_aug_4_18e",
        "traffic": "train_dp4_b2", "chips": 4,
        "why": "data-parallel train step on 4 cards over NCCL, B=2 a card"}
# the train cells' metrics whose reading means the same on rank 0
TRAIN_METRICS = ("train_frames_per_s", "train.dispatch_ms",
                 "train.device_idle_pct", "train.mfu_pct", "train.launches")
DP_LAYER = "data-parallel exchange (parallel/dp_step.py, parallel/dist.py)"


def dp_checkout(root: Path) -> Path:
    """The benchmark's configurations, traffic and metrics under ``root``,
    and a ``BENCHMARK.json`` with the cell; returns its path."""
    pb = run.ROOT / "portbench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(pb / d, root / "portbench" / d)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(CELL)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in TRAIN_METRICS:
            m["workloads"].append(CELL["name"])
    for name, unit in (("dp.nccl_ms", "ms"),
                       ("dp.collectives", "collectives")):
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "device_trace", "layer": DP_LAYER,
            "moves": "train_frames_per_s", "workloads": [CELL["name"]]})
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def dp_run(bench_path, trace=False, fault=None, seed=2147483907):
    """One tiny run of the cell over two gloo ranks, this process rank 0."""
    return run.run_cell(CELL["name"], seed, 0.5, trace, device="cpu",
                        config_overrides=TINY, traffic_overrides=TINY_TRAFFIC,
                        fault=fault, bench_path=bench_path, world=2)
