"""The program's profiler ranges (``rangedet_tpu_torch/utils/spans.py``):
where the eval and train steps open them and how they nest, that they
cost no ``record_function`` and change no output with the profiler off,
that both ways of starting the profiler record them, the eval CLI's
trace, and (on a card) that ``host_sync`` covers every wait of the eval
step for the card."""
import ast
import contextlib
import glob
import json
import os
import warnings
from pathlib import Path
from unittest import mock

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from rangedet_tpu_torch.configs import load_config
from rangedet_tpu_torch.data.synthetic import make_batch
from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
from rangedet_tpu_torch.models import RangeDet
from rangedet_tpu_torch.ops import nms
from rangedet_tpu_torch.train.state import create_train_state
from rangedet_tpu_torch.train.train_step import (
    batch_to_device,
    make_train_step,
)
from rangedet_tpu_torch.utils import logger as tlogger
from rangedet_tpu_torch.utils import spans

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

RECIPE = "rangedet_veh_wo_aug_4_18e"
# torch_parity.TINY_PORT_CONFIG's values: that module imports JAX, which
# this file, run on the card too, must not
TINY = dict(
    feat_size=(16, 128), pad_field=(16, 128), max_gt_boxes=32,
    num_block={"res1": 2, "res2a": 1, "res2": 1, "res3a": 1, "res3": 1,
               "agg1": 1, "agg2": 1, "agg2a": 1, "agg3": 1},
    num_filter={"res1": 16, "res2a": 16, "res2": 32, "res3a": 32,
                "res3": 32, "agg1": 16, "agg2": 32, "agg2a": 16, "agg3": 16},
    meta_units={"res1_unit2": dict(channel_list=(8, 16))},
    cls_conv_layers=1, cls_conv_channel=32, reg_conv_layers=1,
    reg_conv_channel=32, device_topk={"veh": 256}, iou_topk_gt=8,
    dtype=torch.float32)
TINY_RECIPE = (
    "import torch\n"
    "from rangedet_tpu_torch.configs import load_config\n\n\n"
    "def get_config(is_train):\n"
    f"    return load_config({RECIPE!r}, is_train).replace(**{TINY!r})\n"
)
# each eval range and the ranges it opens in (None: the step's top)
EVAL_PARENT = {"forward": {None}, "postprocess": {None},
               "topk": {"postprocess"}, "decode": {"postprocess"},
               "wnms": {"postprocess"}, "wnms.round": {"wnms"},
               "host_sync": {"wnms", "wnms.round"}}
STAGES = ("targets", "forward", "losses", "backward", "optimizer")


def _model(cfg, device):
    """Seeded weights with the cls logits' biases at +3: every pixel
    clears min_score, so the weighted NMS runs many rounds."""
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "cls_logit" in name and name.endswith("bias"):
                p.fill_(3.0)
    return model.to(device)


def _eval(cfg, device, batch_size):
    model = _model(cfg, device).eval()
    inputs = build_eval_inputs(make_batch(cfg, batch_size, seed=0), cfg,
                               device)
    return make_eval_step(model, cfg), inputs


def _ranges(prof, names):
    """[(name, start, end)] of the host ranges named ``names``, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name in names),
                  key=lambda r: (r[1], -r[2]))


def _parent(r, ranges):
    """The innermost of ``ranges`` that holds ``r`` (None: none does)."""
    outer = [o for o in ranges if o is not r and o[1] <= r[1]
             and r[2] <= o[2] and (o[1], o[2]) != (r[1], r[2])]
    return max(outer, key=lambda o: o[1])[0] if outer else None


def test_eval_step_opens_its_spans_nested():
    cfg = load_config(RECIPE, False).replace(**TINY)
    step, inputs = _eval(cfg, torch.device("cpu"), 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(inputs)
    ranges = _ranges(prof, EVAL_PARENT)
    names = [r[0] for r in ranges]
    assert set(names) == set(EVAL_PARENT)
    for r in ranges:
        assert _parent(r, ranges) in EVAL_PARENT[r[0]], r
    rounds = names.count("wnms.round")
    assert rounds > 1
    # the loop's check: its rounds plus one, every class in one call;
    # inside each round the IoU rows' two list indexes (rotated_iou._ccw)
    checks = [r for r in ranges
              if r[0] == "host_sync" and _parent(r, ranges) == "wnms"]
    assert len(checks) == rounds + 1
    assert names.count("host_sync") == len(checks) + 2 * rounds
    # the top-k, decode and weighted NMS of every class, once a step
    assert names.count("topk") == names.count("decode") == 1
    assert names.count("wnms") == 1
    assert names.count("forward") == names.count("postprocess") == 1


def test_spans_off_open_no_record_function_and_change_nothing():
    cfg = load_config(RECIPE, False).replace(**TINY)
    step, inputs = _eval(cfg, torch.device("cpu"), 2)
    assert not autograd_profiler._is_profiler_enabled
    with mock.patch.object(autograd_profiler, "record_function",
                           side_effect=AssertionError("a range opened")) as rf:
        off = step(inputs)
    assert rf.call_count == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = step(inputs)
    assert "wnms.round" in {e.name for e in prof.events()}
    for name, res in off.items():
        for k, v in res.items():
            assert torch.equal(v, on[name][k]), (name, k)


def test_train_step_stages_in_order_inside_train_step():
    cfg = load_config(RECIPE, True).replace(**TINY)
    model = _model(cfg, torch.device("cpu"))
    state = create_train_state(model, cfg, 10, seed=None)
    step = make_train_step(state, cfg)
    batch = batch_to_device(make_batch(cfg, 1, seed=0), torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch)
    ranges = _ranges(prof, ("train_step",) + STAGES)
    assert [r[0] for r in ranges] == ["train_step", *STAGES]
    assert all(_parent(r, ranges) == "train_step" for r in ranges[1:])


def test_ranges_open_only_through_the_helper():
    """No program module but the helper calls ``record_function``, so no
    range costs its bookkeeping with the profiler off; the profiling
    tools may."""
    import rangedet_tpu_torch

    pkg = Path(rangedet_tpu_torch.__file__).parent
    for path in pkg.rglob("*.py"):
        if path.name == "spans.py" or path.name.startswith("profile_"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, (ast.Import, ast.ImportFrom))
                     else [node.attr] if isinstance(node, ast.Attribute)
                     else [])
            assert "record_function" not in names, path


@pytest.mark.parametrize("how", ["profiler_hook", "profile_context"])
def test_span_records_under_either_profiler_start(tmp_path, how):
    def work(i):
        with spans.span(f"spans_test_{i}"):
            torch.ones(4, 4) @ torch.ones(4, 4)

    if how == "profiler_hook":
        hook = tlogger.ProfilerHook(str(tmp_path), 1, 1)
        for i in range(3):
            hook(i)
            work(i)
        hook.close()
        (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
        with open(path) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
    else:
        work(0)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            work(1)
        work(2)
        names = {e.name for e in prof.events()}
    assert {n for n in names if n and n.startswith("spans_test_")} == {
        "spans_test_1"}
    assert spans.span("after") is spans.span("another")  # the null context


def test_eval_cli_writes_a_trace_of_its_steps(tmp_path):
    from rangedet_tpu_torch.tools import test as cli

    recipe = tmp_path / "tiny_recipe.py"
    recipe.write_text(TINY_RECIPE)
    cli.main(["--config", str(recipe), "--synthetic", "3", "--batch", "1",
              "--device", "cpu", "--experiment-dir", str(tmp_path / "exp"),
              "--output", str(tmp_path / "pred.pkl"),
              "--profile-steps", "1"])
    (path,) = glob.glob(str(tmp_path / "exp" / "*" / "eval_traces"
                            / "*.pt.trace.json"))
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    # step 1 alone: one forward, one post-processing
    assert names.count("forward") == names.count("postprocess") == 1
    assert {"topk", "decode", "wnms", "host_sync"} <= set(names)
    assert os.path.exists(tmp_path / "pred.pkl")


@pytest.mark.cuda
def test_host_syncs_are_every_wait_of_the_eval_step_on_cuda():
    """At full size on the card, the eval step's synchronizing calls (as
    ``torch.cuda.set_sync_debug_mode`` reports them) are as many as its
    ``host_sync`` ranges: the weighted NMS is one kernel launch, so, with
    the profiler off or on, both are 0 and no ``wnms.round`` opens. While
    the profiler records, and only then, the step keeps the kernel's
    rounds a row on the card (``nms.take_rounds``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's kernels have no CPU mode "
                    "at full size")
    dev = torch.device("cuda")
    cfg = load_config(RECIPE, False)
    step, inputs = _eval(cfg, dev, 4)
    step(inputs)
    torch.cuda.synchronize()
    nms.take_rounds()
    rounds = []
    real = nms.wnms_kernel

    def keep(*a, **kw):
        out = real(*a, **kw)
        rounds.append(out[2])
        return out

    def waits(profiled):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with (profile(activities=[ProfilerActivity.CPU]) if profiled
                  else contextlib.nullcontext()) as prof, \
                    mock.patch.object(nms, "wnms_kernel", keep):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step(inputs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        return prof, sorted({(w.filename, w.lineno) for w in caught
                             if "called a synchronizing CUDA operation"
                             in str(w.message)})

    _, off = waits(False)
    assert off == [], off
    assert nms.take_rounds() == []
    prof, on = waits(True)
    names = [e.name for e in prof.events()]
    assert names.count("wnms") == len(cfg.class_names)
    assert names.count("wnms.round") == 0
    assert len(on) == names.count("host_sync") == 0, on
    kept, = nms.take_rounds()
    assert kept is rounds[-1] and int(kept.max()) > 0
