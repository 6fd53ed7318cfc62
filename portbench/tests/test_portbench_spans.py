"""The readers of the program's own ranges (``portbench/spans.py``): on a
made-up trace, what each counts, and how the breakdown labels idle time;
on the tiny CPU eval cell with ``--trace 1``, the round count read, and
the device readings read nothing without a card."""
from types import SimpleNamespace

import torch

from portbench import run, spans
from portbench.trace import Trace

from tiny import TINY, TINY_TRAFFIC

torch.set_num_threads(2)


def test_readers_on_a_made_up_trace():
    """Two steps; "wnms" open at [100, 200) and [500, 600), "topk" at
    [0, 50); a launch at t ties its device work by correlation id."""
    trace = SimpleNamespace(
        steps=2,
        ranges={"wnms": [(100, 200), (500, 600)], "topk": [(0, 50)],
                "wnms.round": [(110, 150), (150, 190), (510, 590)],
                "postprocess": [(0, 200), (400, 600)]},
        launch={1: 10, 2: 120, 3: 199, 4: 200, 5: 550, 6: 560},
        device=[("k_a", 0, 1_000_000, 1), ("k_b", 0, 2_000_000, 2),
                ("Memcpy DtoH", 0, 500_000, 3), ("k_c", 0, 4_000_000, 4),
                ("k_d", 0, 8_000_000, 5), ("Memset (Device)", 0, 0, 6),
                ("k_unlaunched", 0, 16_000_000, 99)])
    assert spans.count(trace, "wnms.round", "wnms") == 1.5
    assert spans.count(trace, "host_sync", "wnms") == 0.0
    assert spans.count(trace, "wnms.round", "absent") is None
    assert spans.launches(trace, ("wnms",)) == 1.0  # k_b, k_d
    assert spans.device_ms(trace, ("wnms",)) == 5.25
    assert spans.device_ms(trace, ("topk", "wnms")) == 5.75
    assert spans.launches(trace, ("train_step",)) is None
    assert spans.launches(SimpleNamespace(**dict(vars(trace), device=[])),
                          ("wnms",)) is None
    assert spans.count(None, "wnms.round", "wnms") is None


def test_idle_gaps_are_labelled_by_the_innermost_range():
    """A window [0, 100) with device work at [10, 20) and [60, 70): the
    gaps' middles fall in "wnms" (inside "postprocess"), "postprocess" and
    no range."""
    trace = object.__new__(Trace)
    trace.t0, trace.t1 = 0, 100
    trace.ranges = {"portbench.window": [(0, 100)],
                    "postprocess": [(0, 60)], "wnms": [(0, 10)]}
    trace.device = [("k", 10, 20, 1), ("k", 60, 70, 2)]
    gaps = dict(trace.idle_gaps())
    assert gaps == {"wnms": 10e-9, "postprocess": 40e-9,
                    "no range": 30e-9}


def test_tiny_eval_cell_reads_rounds():
    out = run.run_cell("veh.eval.b4", 2147483901, 0.5, True, device="cpu",
                       config_overrides=TINY, traffic_overrides=TINY_TRAFFIC)
    got = out["result"]["metrics"]
    rounds = got["eval.wnms_rounds"]["value"]
    assert rounds >= 1
    assert got["eval.wnms_rounds"]["unit"] == "rounds"
    # no card: nothing ran on a device, so no device reading
    for name in ("eval.topk_decode_ms", "eval.wnms_device_ms",
                 "eval.wnms_launches"):
        assert name not in got
    # no device work: the whole window is one gap, labelled by a range of
    # the run or "no range"
    labels = {n for n, _ in out["result"]["breakdown"]["idle_gaps"]}
    assert labels and labels <= {"no range", "portbench.step",
                                 "portbench.to_host", "portbench.forward",
                                 "forward", "postprocess", "topk", "decode",
                                 "wnms", "wnms.round", "host_sync",
                                 "meta_block"}
    assert out["result"]["correct"]
