"""Run one cell of the benchmark once, on the card(s) of this machine:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``portbench/configs/<config>.json``), its traffic
(``portbench/traffic/<traffic>.json``) and its metrics
(``portbench/metrics/<metric>.py``); nothing here names a cell.

A run: weights from the seed on the card (``weights.py``), a pool of
distinct seeded batches on the card (``traffic/frames.py``) (both from
the traffic's ``content_seed`` where it names one: every run then does
the same work, the seed drawing its order; see ``plan``), the cell's
shapes warmed up (the training cells' first steps, the eval cell's first
steps); then the window, ``--seconds`` long, drives the program's train
step (``train_step.build_train_step_fn``) or eval step
(``infer.make_eval_step``) over the pool, back to back. With ``--trace 1``
its first steps run under ``torch.profiler``, and after the window the
eval cell times its post-processing alone (``POST_STEPS``). Then the
program's state is freed and the plain reference judges what the timed
path produced (``check.py``). The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error.

A training cell of ``chips`` > 1 runs the program's data-parallel step,
one process a card (``dp.py``): rank r takes frames [r B, (r + 1) B) of
each global batch of ``chips`` x B frames (B the traffic's
``frames_per_card``), which are the one-card pool's batches of that many
frames; rank 0 alone is traced, reads the first steps and prints the
result, and its reference is the one-card step's over the global batch.

Exits 2 without the cards the cell asks for, 3 if the process holds JAX
or the JAX package once the window has closed, 4 if a rank of a
data-parallel cell fails; each time with no result.
"""
from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# one thread for the host's numerical libraries: the window is paced by
# the main thread's dispatch, which idle spinning threads would slow
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rangedet_tpu")
# every cache of the program and of torch at a fixed place in the checkout
CACHES = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR":
          "build/torch_extensions", "CUDA_CACHE_PATH": "build/cuda_cache"}
# eval steps after the window of a traced run, each waiting for its
# forward's kernels before its post-processing's clock starts
POST_STEPS = 20


class Refused(Exception):
    """The run cannot measure: it exits with ``code`` and no result."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


# ------------------------------------------------------------------ the spec
def load_spec(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """(BENCHMARK.json, the cell, its configuration file, its traffic)."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    root = bench_path.parent
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics
    (trace 1): those that list the cell, or that list none and (per-layer)
    move an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def load_reader(name: str, root: Path = ROOT) -> Callable:
    """``portbench/metrics/<name>.py``'s ``read(ctx)``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(config: dict, is_train: bool):
    """The program's config: the recipe with every value of the file's
    ``config`` section that the program's config has."""
    import dataclasses

    import torch

    from rangedet_tpu_torch.configs import load_config

    cfg = load_config(config["recipe"], is_train)
    fields = {f.name for f in dataclasses.fields(cfg)}
    kw = {}
    for k, v in config["config"].items():
        if k not in fields:
            continue
        if k == "dtype":
            v = getattr(torch, v)
        elif k == "fpn_intervals":
            v = {int(s): tuple(b) for s, b in v.items()}
        elif k == "meta_units":
            v = {u: {"channel_list": tuple(m["channel_list"])}
                 for u, m in v.items()}
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cfg.replace(**kw)


def prepare(workload: str, bench_path: Path, config_overrides: dict = None,
            traffic_overrides: dict = None):
    """``load_spec`` with the tests' overrides, and every cache of the
    program at its place in the checkout."""
    bench, cell, config, traffic = load_spec(workload, bench_path)
    config = json.loads(json.dumps(config))
    config["config"].update(config_overrides or {})
    traffic = dict(traffic, **(traffic_overrides or {}))
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    return bench, cell, config, traffic


def global_traffic(traffic: dict, world: int) -> dict:
    """The traffic of a global batch: ``world`` cards' frames."""
    return dict(traffic, frames_per_card=traffic["frames_per_card"] * world)


def rank_pool(seed: int, traffic: dict, c: dict, rank: int, world: int
              ) -> List[dict]:
    """Rank ``rank``'s rows of each of the pool's global batches, made
    alone (with one rank, the pool)."""
    from .traffic.frames import make_pool

    b = traffic["frames_per_card"]
    return make_pool(seed, global_traffic(traffic, world), c,
                     frames=range(rank * b, (rank + 1) * b))


def to_device(batch, dev):
    import torch

    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _host(t):
    """A copy on the host (``.cpu()`` of a CPU tensor would alias it)."""
    return t.detach().to("cpu", copy=True)


# ---------------------------------------------------------------- the window
def run_window(call: Callable[[int], None], seconds: float, trace_steps: int,
               sync: Callable[[], None], group=None):
    """call(i) runs window step i. The first ``trace_steps`` steps (none
    with 0) run under the profiler inside the ``portbench.window`` range.
    The window lasts ``seconds`` from its first step, and its untraced
    steps at least half of that (the profiler's teardown can take
    seconds); it ends on a sync. Returns a record of it.

    With a ``group`` (``dp.Group``, a data-parallel cell) every rank runs
    the same steps, rank 0 alone under the profiler: the window opens on a
    barrier, rank 0's clock decides when it closes, its decision shared by
    a vote every ``dp.STOP_EVERY`` steps (on the host: no step waits for
    the card), and it closes on a sync and a barrier."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .dp import STOP_EVERY
    from .trace import WINDOW

    sync()
    if group is not None:
        group.barrier()
        if group.rank == 0:
            print("portbench: the window opens", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    i, prof = 0, None
    if trace_steps:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        traced_here = group is None or group.rank == 0
        with (profile(activities=acts) if traced_here
              else contextlib.nullcontext()) as prof:
            with record_function(WINDOW):
                for _ in range(trace_steps):
                    call(i)
                    i += 1
                sync()
    traced = i
    t_u = time.perf_counter()
    deadline = max(t0 + seconds, t_u + seconds / 2)
    if group is None:
        while time.perf_counter() < deadline or i == traced:
            call(i)
            i += 1
    else:
        while True:
            call(i)
            i += 1
            if ((i - traced) % STOP_EVERY == 0
                    and group.vote(time.perf_counter() >= deadline)):
                break
    sync()
    if group is not None:
        group.barrier()
    t_end = time.perf_counter()
    return SimpleNamespace(prof=prof, traced=traced, t0=t0, steps=i - traced,
                           seconds=t_end - t_u, all_steps=i,
                           all_seconds=t_end - t0)


# ------------------------------------------------------------------ training
def train_cell(cfg, c, config, traffic, pool, dev, sync, seconds, trace,
               seed, fault=None, group=None):
    """Set up the program's train step from the benchmark's weights, run
    its first steps (the warm-up, which the reference follows) and the
    window. Returns (window record, the program's readings: the total loss
    of the first three steps, the momentum buffers after the first, the
    parameters after the third). With a ``group`` (``dp.Group``) the step
    is the program's data-parallel one over it, set up as
    ``tools/train.py`` sets it up: rank 0's weights on every rank, the
    BatchNorms' sync group as ``cfg.sync_bn`` says; the readings are this
    rank's (its rows' forward, the reduced loss and gradient)."""
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.train import train_step as ts
    from rangedet_tpu_torch.train.state import create_train_state

    from . import faults
    from .reference.train import STAGES1
    from .weights import model_weights

    model = RangeDet(**cfg.model_kwargs()).to(dev)
    model.load_state_dict(model_weights(c, seed, dev), strict=True)
    spe = config["assumed"]["steps_per_epoch"]
    state = create_train_state(model, cfg, spe, seed=None)
    if group is None:
        step = ts.build_train_step_fn(state, cfg)
    else:
        from rangedet_tpu_torch.models.layers import set_sync_group
        from rangedet_tpu_torch.parallel.dist import replicate_state

        replicate_state(state.model, group.group)
        set_sync_group(state.model, group.group if cfg.sync_bn else None)
        step = ts.build_train_step_fn(state, cfg, group.group)
    if fault is not None:
        step = faults.TRAIN[fault](step, state, cfg)
    names = {p: n for n, p in model.named_parameters()}
    n_warm = traffic["warmup_steps"]
    readings = {"losses": [], "stages1": {}}

    # the first step's outputs and stage outputs, for the check
    def first_forward(module, args, out):
        readings["forward1"] = tuple([_host(t) for t in o] for o in out)
        for h in hooks:
            h.remove()

    def keeper(name):
        def keep(module, args, out):
            readings["stages1"][name] = _host(out)
        return keep

    hooks = [model.register_forward_hook(first_forward)] + [
        getattr(model.backbone, k).register_forward_hook(keeper(k))
        for k in STAGES1]
    for n in range(n_warm):
        metrics = step(pool[n % len(pool)])
        if n < 3:
            readings["losses"].append(float(metrics["total_loss"]))
        if n == 0:
            readings["buf1"] = {
                name: _host(state.optimizer.state[p]["momentum_buffer"])
                for p, name in names.items()
                if "momentum_buffer" in state.optimizer.state.get(p, {})}
        if n == 2:
            readings["params"] = {name: _host(p) for p, name in names.items()}
    call_ms: List[float] = []

    def call(i):
        t = time.perf_counter()
        step(pool[(n_warm + i) % len(pool)])
        call_ms.append((time.perf_counter() - t) * 1e3)

    rec = run_window(call, seconds, traffic["trace_steps"] if trace else 0,
                     sync, group)
    rec.call_ms = call_ms[rec.traced:]
    del step, state, model
    return rec, readings


# ---------------------------------------------------------------------- eval
def eval_cell(cfg, c, traffic, pool, dev, sync, seconds, trace, sample,
              order, seed, fault=None):
    """Set up the program's eval step, warm it up, and run the window,
    keeping the sampled steps' outputs on the host and their forward's
    logits and deltas; step i takes the pool's batch ``order[i % len]``; a traced run then times ``POST_STEPS`` steps' post-
    processing alone. Returns (window record, {step: (pool index, host
    outputs, (logits, deltas))})."""
    from torch.profiler import record_function

    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from rangedet_tpu_torch.models import RangeDet

    from . import faults
    from .weights import model_weights

    model = RangeDet(**cfg.model_kwargs()).to(dev)
    model.load_state_dict(model_weights(c, seed, dev), strict=True)
    model.eval()
    inputs = [build_eval_inputs(b, cfg, dev) for b in pool]
    step = make_eval_step(model, cfg)
    if fault is not None:
        step = faults.EVAL[fault](step)
    now = {"step": -1, "rf": None, "t_fwd": 0.0, "wait": False}
    captured: Dict[int, tuple] = {}

    def pre_hook(module, args):
        now["rf"] = record_function("portbench.forward")
        now["rf"].__enter__()

    def post_hook(module, args, out):
        now["rf"].__exit__(None, None, None)
        if now["wait"]:
            sync()
        now["t_fwd"] = time.perf_counter()
        if now["step"] in sample:
            captured[now["step"]] = tuple([t.clone() for t in o] for o in out)

    hooks = [model.register_forward_pre_hook(pre_hook),
             model.register_forward_hook(post_hook)]
    n_warm = traffic["warmup_steps"]
    for n in range(n_warm):
        out = step(inputs[order[n % len(inputs)]])
        _ = {k: {kk: v.cpu() for kk, v in r.items()} for k, r in out.items()}
    lat_ms: List[float] = []
    post_ms: List[float] = []
    kept: Dict[int, tuple] = {}

    def call(i):
        now["step"] = i
        j = order[(n_warm + i) % len(inputs)]
        t = time.perf_counter()
        with record_function("portbench.step"):
            out = step(inputs[j])
            with record_function("portbench.to_host"):
                host = {k: {kk: v.cpu() for kk, v in r.items()}
                        for k, r in out.items()}
        t1 = time.perf_counter()
        lat_ms.append((t1 - t) * 1e3)
        if now["wait"]:
            post_ms.append((t1 - now["t_fwd"]) * 1e3)
        if i in sample:
            kept[i] = (j, host)

    rec = run_window(call, seconds, traffic["trace_steps"] if trace else 0,
                     sync)
    rec.lat_ms = lat_ms[rec.traced:]
    if trace:
        # after the window: the forward's kernels finished before the
        # post-processing's clock starts, so it times top-k, decode, the
        # weighted NMS and the copy to the host alone
        now["wait"] = True
        for i in range(rec.all_steps, rec.all_steps + POST_STEPS):
            call(i)
        sync()
    rec.post_ms = post_ms
    for h in hooks:
        h.remove()
    out = {i: (j, host, captured.get(i)) for i, (j, host) in kept.items()}
    del step, model, inputs
    return rec, out


# ----------------------------------------------------------------- one cell
def content_seed(seed: int, traffic: dict) -> int:
    """The seed of the run's frames and weights: the traffic's fixed
    ``content_seed`` where it names one, else the run's own."""
    return int(traffic.get("content_seed", seed))


def plan(seed: int, traffic: dict):
    """(the eval steps checked, the order in which the window takes the
    pool's batches), drawn from the run's seed; training takes the pool in
    its order and checks its first steps."""
    import numpy as np

    n = traffic["pool_batches"]
    if traffic["mode"] == "train":
        return set(), list(range(n))
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
    sample = {int(s) for s in rng.choice(
        traffic["sample_from_steps"], traffic["sample_steps"], replace=False)}
    return sample, [int(k) for k in rng.permutation(n)]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: Optional[str] = None, config_overrides: dict = None,
             traffic_overrides: dict = None, fault: Optional[str] = None,
             bench_path: Path = ROOT / "BENCHMARK.json",
             t_start: float = T_START, world: Optional[int] = None) -> dict:
    """One run of ``workload``. ``device`` None: the card, checked; else
    "cpu", for the tests, with smaller shapes (the overrides), a fault
    of ``faults.py`` planted in the timed path, and a data-parallel cell
    over ``world`` gloo ranks (the cell's cards by default). Returns
    {"result": the result line's object, "checks": {name: (value,
    limit)}, "detail", "timings"}; on a data-parallel cell this process is
    rank 0."""
    bench, cell, config, traffic = prepare(workload, bench_path,
                                           config_overrides,
                                           traffic_overrides)
    import torch

    chips = cell["chips"]
    world = chips if world is None else world
    if world > 1 and traffic["mode"] != "train":
        raise SystemExit(f"{workload}: only training runs on several cards")
    if device is None:
        if not torch.cuda.is_available():
            raise Refused(2, "no CUDA card")
        if torch.cuda.device_count() < chips:
            raise Refused(2, f"{torch.cuda.device_count()} cards, the cell "
                             f"asks for {chips}")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    from rangedet_tpu_torch import _build

    timings = {"imports_s": time.perf_counter() - t_start}
    if dev.type == "cuda":
        _build.load()
        torch.zeros(1, device=dev)
    timings["build_s"] = time.perf_counter() - t_start - timings["imports_s"]
    group = None
    if world > 1:  # the library is built: start the other ranks
        from . import dp

        group = dp.launch(dict(workload=workload, seed=seed, seconds=seconds,
                               trace=trace, device=device,
                               config_overrides=config_overrides,
                               traffic_overrides=traffic_overrides,
                               fault=fault, bench_path=str(bench_path)),
                          world, dev, seconds)
        timings["join_s"] = (time.perf_counter() - t_start
                             - timings["imports_s"] - timings["build_s"])
    c = config["config"]
    train = traffic["mode"] == "train"
    cfg = port_config(config, train)
    from .traffic.frames import make_pool

    t = time.perf_counter()
    data = content_seed(seed, traffic)
    pool = [to_device(b, dev) for b in rank_pool(data, traffic, c, 0, world)]
    timings["pool_s"] = time.perf_counter() - t
    sample, order = plan(seed, traffic)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        if train:
            rec, prog = train_cell(cfg, c, config, traffic, pool, dev, sync,
                                   seconds, trace, data, fault, group)
        else:
            rec, outs = eval_cell(cfg, c, traffic, pool, dev, sync, seconds,
                                  trace, sample, order, data, fault)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        if group is not None:  # the fullest card's peak; the ranks end
            peak = int(group.max(peak))
            group.close()
    except BaseException:
        if group is not None:
            group.abort()
        raise
    setup_s = rec.t0 - t_start
    timings["setup_s"] = setup_s
    timings["window_ms_a_step"] = 1e3 * rec.seconds / rec.steps
    tr = None
    if rec.prof is not None:
        from .trace import Trace

        t = time.perf_counter()
        tr = Trace(rec.prof, rec.traced)
        rec.prof = None
        timings["trace_s"] = time.perf_counter() - t
    del pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference, once the program's state is freed
    from .check import reference_train, train_gaps, train_numbers
    from .weights import model_weights

    t_ref = time.perf_counter()
    detail = None
    P0 = model_weights(c, data, dev)
    if train:
        first = [to_device(b, dev) for b in make_pool(
            data, global_traffic(traffic, world), c, batches=range(3))]
        ref = reference_train(P0, c, config["assumed"]["steps_per_epoch"],
                              first)
        del first
        P0c = {k: v.cpu() for k, v in P0.items()}
        refc = host_readings(ref)
        detail = train_gaps(program_readings(prog, P0c, c), refc, P0c)
        numbers = train_numbers(detail)
    else:
        numbers = eval_numbers(outs, P0, c, data, traffic, dev)
    sync()
    timings["reference_s"] = time.perf_counter() - t_ref
    limits = config["limits"][traffic["mode"]]
    checks = {k: (float(v), float(limits[k])) for k, v in numbers.items()}
    correct = all(v <= lim for v, lim in checks.values())

    rec.frames_per_step = traffic["frames_per_card"] * world
    rec.frames = rec.steps * rec.frames_per_step
    ctx = SimpleNamespace(mode=traffic["mode"], c=c, traffic=traffic,
                          window=rec, trace=tr, setup_s=setup_s,
                          peak_bytes=peak, chips=world)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = load_reader(m["name"], bench_path.parent)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": world, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(rec.all_steps),
              "failed": 0, "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return {"result": result, "checks": checks, "detail": detail,
            "timings": timings}


def rank_main(spec: dict) -> int:
    """Rank r > 0 of a data-parallel cell, started by ``dp.launch`` with
    rank 0's ``run_cell`` arguments: join, make this rank's rows of the
    pool, run the same warm-up and window as rank 0 (untraced), give rank
    0 this card's peak, and end. Returns the exit code."""
    from . import dp

    bench_path = Path(spec["bench_path"])
    _, _, config, traffic = prepare(spec["workload"], bench_path,
                                    spec["config_overrides"],
                                    spec["traffic_overrides"])
    import torch

    from rangedet_tpu_torch import _build

    rank, world = spec["rank"], spec["world"]
    dev = torch.device(spec["device"] or "cuda",
                       None if spec["device"] else rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _build.load()  # rank 0 built it before it started this rank
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    group = dp.join(rank, world, spec["port"], dev, None)
    c = config["config"]
    cfg = port_config(config, True)
    data = content_seed(spec["seed"], traffic)
    pool = [to_device(b, dev)
            for b in rank_pool(data, traffic, c, rank, world)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    train_cell(cfg, c, config, traffic, pool, dev, sync, spec["seconds"],
               spec["trace"], data, spec["fault"], group)
    group.max(torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
              else 0)
    group.close()
    found = jax_modules()
    if found:
        print(f"portbench: rank {rank} holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    return 0


def eval_numbers(outs, P0, c, seed, traffic, dev) -> Dict[str, float]:
    """The eval numbers over the sampled steps: the forward against the
    reference's on the step's batch, the post-processing against the
    reference's on the program's own logits and deltas."""
    from .check import boxes_numbers, forward_gap, reference_forward
    from .traffic.frames import make_pool

    numbers = {"forward_gap": 0.0, "boxes_mismatch": 0.0, "boxes_gap": 0.0}
    if not outs:
        return {k: float("nan") for k in numbers}
    batches = sorted({j for j, _, _ in outs.values()})
    pool = dict(zip(batches, (to_device(b, dev) for b in make_pool(
        seed, traffic, c, batches=batches))))
    refs: Dict[int, tuple] = {}
    for i, (j, host, fwd) in sorted(outs.items()):
        if fwd is None:
            numbers["forward_gap"] = float("nan")
            continue
        if j not in refs:
            refs[j] = reference_forward(P0, c, pool[j])
        numbers["forward_gap"] = max(numbers["forward_gap"],
                                     forward_gap(fwd, refs[j]))
        bx = boxes_numbers(host, fwd, pool[j], c)
        numbers["boxes_mismatch"] += bx["boxes_mismatch"]
        numbers["boxes_gap"] = max(numbers["boxes_gap"], bx["boxes_gap"])
    return numbers


def program_readings(prog: dict, P0: dict, c: dict) -> dict:
    """The program's first gradient as SGD got it, from its momentum
    buffer after one step: buf = g + wd p0 (a leaf without a buffer had
    no gradient)."""
    grad1 = {k: prog["buf1"][k] - c["weight_decay"] * P0[k]
             if k in prog["buf1"] else P0[k].new_zeros(P0[k].shape)
             for k in prog["params"]}
    return {"losses": prog["losses"], "forward1": prog["forward1"],
            "stages1": prog["stages1"], "grad1": grad1,
            "params": prog["params"]}


def host_readings(ref: dict) -> dict:
    """The reference's readings (``reference.train.train_steps``) on the
    host."""
    return {"losses": ref["losses"],
            "forward1": tuple([t.cpu() for t in o] for o in ref["forward1"]),
            "stages1": {k: v.cpu() for k, v in ref["stages1"].items()},
            "grad1": {k: v.cpu() for k, v in ref["grad1"].items()},
            "params": {k: v.cpu() for k, v in ref["params"].items()}}


def jax_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    found = jax_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    emit(out)
    return 0


def emit(out: dict) -> None:
    """Where the set-up and the check's time went, then the numbers
    compared, each beside its limit, as the last lines of standard error;
    the result as the last line of standard output."""
    print("timings " + " ".join(f"{k} {v:.3f}" for k, v in
                                out["timings"].items()), file=sys.stderr)
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
