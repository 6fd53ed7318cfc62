"""The harness on the CPU at the tiny size: a cell and a metric added as
files alone are found; the result's last line is the contract's JSON
object; planted faults turn ``correct`` false; the command refuses to run
without a card; and no module of the benchmark imports JAX or the JAX
package (nor the reference anything of the program)."""
import ast
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench import faults, run

from tiny import TINY, TINY_TRAFFIC

torch.set_num_threads(2)
PB = run.ROOT / "portbench"
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _tiny_run(workload, trace=False, fault=None, bench_path=None, seed=3):
    kw = {} if bench_path is None else {"bench_path": bench_path}
    return run.run_cell(workload, seed, 0.5, trace, device="cpu",
                        config_overrides=TINY,
                        traffic_overrides=TINY_TRAFFIC, fault=fault, **kw)


@pytest.mark.parametrize("cell", ["veh.train.b8", "veh.eval.b4"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_is_the_result(cell, trace):
    out = _tiny_run(cell, trace)
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        run.emit(out)
    res = json.loads(so.getvalue().splitlines()[-1])
    assert all(k in res for k in KEYS)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert res["metrics"] and all(
        set(m) == {"value", "unit"} for m in res["metrics"].values())
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in run.cell_metrics(bench, cell, trace)}
    assert set(res["metrics"]) <= want
    if not trace:  # the CPU has no device memory to read
        assert set(res["metrics"]) == want - {"peak_mem_gib"}
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    lines = se.getvalue().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1] for ln in lines] == list(res["checks"])


def test_new_cell_and_metric_are_found(tmp_path):
    """A later PR adds a traffic file, a metric file and entries in
    BENCHMARK.json, and edits nothing."""
    root = tmp_path / "checkout"
    shutil.copytree(PB / "configs", root / "portbench" / "configs")
    shutil.copytree(PB / "traffic", root / "portbench" / "traffic")
    shutil.copytree(PB / "metrics", root / "portbench" / "metrics")
    traffic = json.loads((PB / "traffic" / "train_b2.json").read_text())
    traffic["frames_per_card"] = 4
    (root / "portbench" / "traffic" / "train_b4.json").write_text(
        json.dumps(traffic))
    (root / "portbench" / "metrics" / "train.frames_per_step.py").write_text(
        "def read(ctx):\n    return ctx.window.frames_per_step\n")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "veh.train.b4",
                              "config": "rangedet_veh_wo_aug_4_18e",
                              "traffic": "train_b4", "chips": 1,
                              "why": "a cell added as files"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_frames_per_s":
            m["workloads"].append("veh.train.b4")
    bench["per_layer"].append({
        "name": "train.frames_per_step", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "step dispatch (train/train_step.py)",
        "moves": "train_frames_per_s", "workloads": ["veh.train.b4"]})
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    out = _tiny_run("veh.train.b4", trace=True, bench_path=path)
    assert out["result"]["metrics"]["train.frames_per_step"]["value"] == 4
    assert out["result"]["correct"]


@pytest.mark.parametrize("name", ["half_batch", "unchanged"])
def test_train_faults_are_caught(name):
    out = _tiny_run("veh.train.b8", fault=name)
    assert out["result"]["correct"] is False


@pytest.mark.parametrize("name", sorted(faults.EVAL))
def test_eval_faults_are_caught(name):
    out = _tiny_run("veh.eval.b4", fault=name)
    assert out["result"]["correct"] is False


def test_refuses_without_a_card(tmp_path):
    """No result and a non-zero exit where the cell's cards are missing,
    and in a directory that holds only the benchmark's files (no
    program)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = [sys.executable, "-m", "portbench.run", "--workload",
            "veh.train.b8", "--seed", "5", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(args, cwd=run.ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    alone = tmp_path / "alone"
    shutil.copytree(PB, alone / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(run.ROOT / "BENCHMARK.json", alone)
    env.pop("PYTHONPATH", None)
    p = subprocess.run(args, cwd=alone, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_a_plain_reference():
    files = [p for p in PB.rglob("*.py") if "__pycache__" not in p.parts]
    assert files
    for p in files:
        for name in _imports(p):
            top = name.split(".")[0]
            assert top not in run.FORBIDDEN, (p, name)
            if "reference" in p.relative_to(PB).parts:
                assert top != "rangedet_tpu_torch", (p, name)
    assert "rangedet_tpu" in run.FORBIDDEN  # whole names: the port passes
    assert "rangedet_tpu_torch".split(".")[0] not in run.FORBIDDEN
