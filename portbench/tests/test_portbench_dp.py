"""The harness's data-parallel path on the CPU: ``veh.train.dp4``
(``dp_cell.py``) over two gloo ranks at the tiny size (the result line and
``correct``; the planted faults are in ``test_portbench_dp_faults.py``), a
rank killed in the window ending the run with no result, the refusal
without the cards, and the trace's split of NCCL's kernels from the busy
time."""
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from portbench import dp, run
from portbench.trace import Trace

from dp_cell import CELL, dp_checkout, dp_run

torch.set_num_threads(1)
TESTS = run.ROOT / "portbench" / "tests"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return dp_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_give_the_result_line(bench, trace):
    out = dp_run(bench, trace)
    res = out["result"]
    assert res["correct"] is True, out["checks"]
    assert res["device"]["count"] == 2
    assert set(out["checks"]) == {"res1_gap", "forward1_gap", "loss1_gap",
                                  "grad_median_gap", "update_median_gap"}
    spec = json.loads(bench.read_text())
    want = {m["name"] for m in run.cell_metrics(spec, CELL["name"], trace)}
    if trace:  # the CPU has no device work: no device reading, no NCCL
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert {"train.mfu_pct", "train.dispatch_ms"} <= set(res["metrics"])
        assert not {"dp.nccl_ms", "dp.collectives"} & set(res["metrics"])
    else:
        assert set(res["metrics"]) == want - {"peak_mem_gib"}
        # the rate counts both ranks' frames: 2 a rank a step
        rate = res["metrics"]["train_frames_per_s"]["value"]
        assert rate > 0
    assert not torch.distributed.is_initialized()


def _children(pid):
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                stat = open(f"/proc/{d}/stat").read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d))
    return out


def test_a_killed_rank_ends_the_run(bench):
    """Rank 1 killed in the window: rank 0 ends at once, exit
    ``dp.EXIT_FAILED``, no result line, no rank left."""
    code = ("from pathlib import Path; from portbench import run; "
            "from tiny import TINY, TINY_TRAFFIC; "
            f"run.emit(run.run_cell('{CELL['name']}', 11, 60.0, False, "
            "device='cpu', config_overrides=TINY, "
            "traffic_overrides=TINY_TRAFFIC, world=2, "
            f"bench_path=Path({str(bench)!r})))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(run.ROOT), str(TESTS)]))
    p = subprocess.Popen([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        for line in p.stderr:
            if "the window opens" in line:
                break
        (child,) = _children(p.pid)
        time.sleep(1.0)
        t = time.monotonic()
        os.kill(child, signal.SIGKILL)
        out, err = p.communicate(timeout=30)
        took = time.monotonic() - t
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == dp.EXIT_FAILED, err
    assert "rank 1 exited with -9" in err
    assert out.strip() == ""
    assert took < 5 * dp.POLL_S + 5


def test_refused_without_four_cards(bench, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(run.Refused) as e:
        run.run_cell(CELL["name"], 3, 1.0, False, bench_path=bench)
    assert e.value.code == 2


def _trace(device):
    tr = object.__new__(Trace)
    tr.t0, tr.t1, tr.steps = 0, 1_000, 2
    tr.ranges = {"portbench.window": [(0, 1_000)]}
    tr.device = device
    return tr


def test_collectives_are_kept_out_of_the_busy_time():
    one_card = [("conv3x3_gemm_kernel", 0, 300, 1),
                ("elementwise_kernel", 200, 400, 2),
                ("Memcpy HtoD", 600, 700, 3)]
    tr = _trace(one_card)
    assert tr.busy_s == 500e-9  # [0, 400) and [600, 700)
    assert tr.collective_s == 0 and tr.collective_launches == 0
    # an NCCL kernel that spins from 300 to 900 and one past the window
    tr = _trace(one_card + [
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)",
         300, 900, 4), ("ncclKernel_Broadcast", 950, 1_200, 5)])
    assert tr.busy_s == 500e-9
    assert tr.collective_s == pytest.approx(650e-9)
    assert tr.collective_launches == 2
    ops = dict(tr.device_ops())
    assert ops["ncclKernel_Broadcast"] == 250e-9  # still a device op
    gaps = dict(tr.idle_gaps())
    assert gaps == {"no range": pytest.approx(500e-9)}
