"""The port's logging (``utils/logger.py``) against the JAX package's, and
the train loop's use of it, on the CPU: the speedometers' lines and
scalars, ScalarWriter's events and tags, ProfilerHook's trace; then
tools.train on frames from ``write_waymo_files``: one metrics fetch per
window of log_frequency steps, log.txt, the TensorBoard tags, and an exact
``--resume`` with AdamWS, onecycle, the global-norm clip and remat."""
import contextlib
import glob
import io
import json
import logging
import os
import re
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from rangedet_tpu.utils import logger as jlogger
from rangedet_tpu_torch.configs import load_config
from rangedet_tpu_torch.data.synthetic import write_waymo_files
from rangedet_tpu_torch.models import RangeDet
from rangedet_tpu_torch.tools import train as train_cli
from rangedet_tpu_torch.train import checkpoint as tckpt
from rangedet_tpu_torch.train import train_step as ttrain_step
from rangedet_tpu_torch.train.schedule import (
    build_momentum_schedule,
    build_schedule,
)
from rangedet_tpu_torch.train.state import create_train_state
from rangedet_tpu_torch.utils import logger as tlogger
from torch_parity import TINY_PORT_CONFIG

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

H, W = 16, 128  # the tiny recipe's feat_size and pad_field
N_TRAIN, N_VAL = 6, 2  # 3 steps an epoch at B=2
SPEED = re.compile(r"speed [0-9.]+ frames/s")
# the recipe of chip_smoke [10]'s CLI run, on the tiny recipe
OPTIONS = dict(optimizer="adamws", lr_mode="onecycle",
               clip_mode="global_norm", remat=True)


@pytest.fixture(scope="module", autouse=True)
def _no_tensorflow():
    """TensorBoard's writer and reader on their own TensorFlow stub, as on
    a machine without TensorFlow: where it is installed, importing it costs
    ~14 s of this file's ~30."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        yield


def _events(log_dir):
    """{tag: [(step, value)]} of the TensorBoard event files in log_dir."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


class _Recorder:
    """A ScalarWriter stand-in that keeps what it is given."""

    def __init__(self):
        self.calls = []

    def scalars(self, tag_values, step):
        self.calls.append((dict(tag_values), step))


def _drive(mod, logger, tb):
    """One sequence of 7 steps of 3 metrics through ``mod``'s
    DetailSpeedometer (frequency 3), the lr given when a line is due."""
    sp = mod.DetailSpeedometer(2, 3, logger, tb=tb)
    due = []
    for i in range(7):
        sp.tick(0.001 * (i + 1), 0.01 * (i + 2))
        due.append(sp.due_next)
        sp(i // 4, i % 4, {"total_loss": 1.0 / (i + 1), "cls_loss_s1": 0.5,
                           "reg_loss_s1": 0.25 * i},
           lr=0.1 * (i + 1) if sp.due_next else None, global_step=10 + i)
    plain = mod.Speedometer(2, 2, logger)
    for i in range(4):
        plain(0, i, {"total_loss": float(i)})
    return due


def test_speedometers_log_the_jax_lines(caplog):
    tb_j, tb_t = _Recorder(), _Recorder()
    with caplog.at_level(logging.INFO):
        due_j = _drive(jlogger, logging.getLogger("speed.jax"), tb_j)
        due_t = _drive(tlogger, logging.getLogger("speed.port"), tb_t)
    lines = {name: [SPEED.sub("speed X frames/s", r.getMessage())
                    for r in caplog.records if r.name == name]
             for name in ("speed.jax", "speed.port")}
    assert len(lines["speed.jax"]) == 4  # 2 detailed, 2 plain
    assert lines["speed.port"] == lines["speed.jax"]
    assert due_t == due_j == [False, False, True] * 2 + [False]
    assert [s for _, s in tb_t.calls] == [s for _, s in tb_j.calls] == [
        12, 15]
    for (a, _), (b, _) in zip(tb_t.calls, tb_j.calls):
        assert sorted(a) == sorted(b)
        assert {k: v for k, v in a.items() if k != "train/frames_per_sec"} \
            == {k: v for k, v in b.items() if k != "train/frames_per_sec"}


def test_scalar_writer_writes_the_jax_tags(tmp_path):
    tags = {}
    for name, mod in (("jax", jlogger), ("port", tlogger)):
        log_dir = str(tmp_path / name)
        tb = mod.ScalarWriter(log_dir, logging.getLogger(f"tb.{name}"))
        _drive(mod, logging.getLogger(f"tb.{name}"), tb)
        tb.scalars({"val/veh_ap": 0.25}, 20)
        tb.flush()
        tb.close()
        tags[name] = _events(log_dir)
    assert sorted(tags["port"]) == sorted(tags["jax"])
    assert {"train/total_loss", "train/lr", "train/frames_per_sec",
            "time/data_ms", "time/step_ms", "val/veh_ap"} <= set(tags["port"])
    for tag, pts in tags["jax"].items():
        assert [s for s, _ in tags["port"][tag]] == [s for s, _ in pts]
        if tag != "train/frames_per_sec":
            np.testing.assert_allclose([v for _, v in tags["port"][tag]],
                                       [v for _, v in pts], rtol=1e-6)


def test_scalar_writer_without_tensorboard_warns_once(tmp_path, caplog):
    log = logging.getLogger("tb.absent")
    tb = tlogger.ScalarWriter(str(tmp_path / "tb"), log)
    with mock.patch.dict(sys.modules, {"torch.utils.tensorboard": None}), \
            caplog.at_level(logging.WARNING):
        tb.scalars({"train/lr": 0.1}, 0)
        tb.scalars({"train/lr": 0.2}, 1)
        tb.flush()
        tb.close()
    warned = [r for r in caplog.records if r.name == "tb.absent"]
    assert len(warned) == 1 and "tensorboard writer unavailable" in \
        warned[0].getMessage()
    assert not os.path.exists(tmp_path / "tb")


@pytest.mark.parametrize("steps", [6, 3])
def test_profiler_hook_traces_its_window(tmp_path, steps):
    # steps 2 and 3 traced: the hook stops at step 4, or at close() when
    # the run ends first
    hook = tlogger.ProfilerHook(str(tmp_path), 2, 2)
    x = torch.ones(8, 8)
    for step in range(steps):
        hook(step)
        with record_function(f"step_{step}"):
            x = x @ x / 8
    hook.close()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    traced = {n for n in names if n and n.startswith("step_")}
    assert traced == {f"step_{s}" for s in range(2, min(steps, 4))}
    assert not tlogger.ProfilerHook(str(tmp_path / "off"), 2, 0)(2)
    assert not os.path.exists(tmp_path / "off")


# ---------------------------------------------------------------- the loop
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A training and a validation split under one root, and the tiny
    recipe at log_frequency 2, as written and with OPTIONS."""
    root = tmp_path_factory.mktemp("logging")
    data = str(root / "data")
    write_waymo_files(data, N_TRAIN, H=H, W=W, seed=1, image_set="training")
    write_waymo_files(data, N_VAL, H=H, W=W, seed=2, image_set="validation")
    tiny = root / "tiny_recipe.py"
    tiny.write_text(TINY_PORT_CONFIG)
    recipes = {}
    for name, over in (("plain", {}), ("options", OPTIONS)):
        kw = ", ".join(f"{k}={v!r}" for k, v in dict(over,
                                                     log_frequency=2).items())
        path = root / f"{name}_recipe.py"
        path.write_text(
            "from rangedet_tpu_torch.configs import load_config\n\n\n"
            "def get_config(is_train):\n"
            f"    return load_config({str(tiny)!r}, is_train).replace("
            f"{kw})\n")
        recipes[name] = str(path)
    return dict(data=data, **recipes)


def _train(recipe, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist, state, val = train_cli.main(
            ["--config", recipe, "--device", "cpu", *argv])
    return hist, state, val, out.getvalue()


def test_loop_fetches_a_window_at_once_and_logs(files, tmp_path):
    exp = str(tmp_path)
    sizes = []
    real = train_cli.fetch_window

    def counted(metrics, keys):
        sizes.append(len(metrics))
        return real(metrics, keys)

    with mock.patch.object(train_cli, "fetch_window", counted):
        hist, state, val, out = _train(
            files["plain"], "--data-root", files["data"], "--sampling-rate",
            "1", "--epochs", "2", "--num-workers", "1", "--eval-every", "2",
            "--eval-frames", str(N_VAL), "--experiment-dir", exp,
            "--tensorboard")
    # 3 steps an epoch, windows of 2: one fetch a window and one for the
    # epoch's last step
    assert sizes == [2, 1, 2, 1] and state.step == 6
    assert [(r["epoch"], r["step"]) for r in hist] == [
        (0, 0), (0, 1), (0, 2), (1, 3), (1, 4), (1, 5)]
    cfg = load_config(files["plain"], is_train=True)
    assert all(np.isfinite(r["total_loss"]) and r["momentum"] == 0.9
               and r["data_ms"] >= 0 and r["step_ms"] > 0 for r in hist)

    with open(os.path.join(exp, cfg.name, "log.txt")) as f:
        log = f.read()
    speed = re.findall(r"Epoch\[(\d+)\] Batch\[(\d+)\] speed [0-9.]+ "
                       r"frames/s lr=([0-9.]+) data_ms=[0-9.]+ "
                       r"step_ms=[0-9.]+ cls_loss_s1=", log)
    # the speedometer counts across epochs: lines at calls 2, 4, 6
    assert [(int(e), int(b)) for e, b, _ in speed] == [(0, 1), (1, 0),
                                                       (1, 2)]
    assert [float(lr) for _, _, lr in speed] == [
        round(hist[i]["lr"], 6) for i in (1, 3, 5)]
    assert f"epoch 1 validation: {val[1]}" in log
    assert all(line in out for line in log.splitlines())  # the console

    tags = _events(os.path.join(exp, cfg.name, "tb"))
    assert {"train/total_loss", "train/lr", "train/frames_per_sec",
            "time/data_ms", "time/step_ms", "val/veh_ap"} <= set(tags)
    assert [s for s, _ in tags["train/total_loss"]] == [1, 3, 5]
    assert tags["val/veh_ap"] == [(6, pytest.approx(val[1]["veh"]["ap"]))]
    np.testing.assert_allclose(
        [v for _, v in tags["train/total_loss"]],
        [np.mean([hist[i]["total_loss"] for i in (j - 1, j)])
         for j in (1, 3, 5)], rtol=1e-6)


def test_resume_with_adamws_onecycle_is_exact(files, tmp_path):
    exp = str(tmp_path)
    common = ("--synthetic", "--steps-per-epoch", "2", "--experiment-dir",
              exp)
    _train(files["options"], "--epochs", "1", *common)
    hist, state, _, out = _train(files["options"], "--epochs", "2",
                                 "--resume", *common)
    assert "resumed from epoch 0" in out and state.step == 4
    assert [r["step"] for r in hist] == [2, 3]

    # the reference: checkpoint 0 in a state whose schedules end at epoch
    # 2, stepped over epoch 1's synthetic batches
    cfg = load_config(files["options"], is_train=True).replace(
        experiment_dir=exp, end_epoch=2)
    cfg = cfg.replace(base_lr=cfg.base_lr * cfg.batch_image / 16.0)
    assert (cfg.optimizer, cfg.lr_mode, cfg.clip_mode, cfg.remat) == (
        "adamws", "onecycle", "global_norm", True)
    ref = create_train_state(RangeDet(**cfg.model_kwargs()), cfg, 2, seed=1)
    _, ep = tckpt.restore_checkpoint(ref, cfg, 0)
    assert ep == 0 and ref.step == 2
    step = ttrain_step.make_train_step(ref, cfg)
    want = [step(ttrain_step.batch_to_device(
        train_cli.synthetic_batch(cfg, 1, i), torch.device("cpu")))
        for i in (0, 1)]
    lr, mom = build_schedule(cfg, 2), build_momentum_schedule(cfg, 2)
    for got, w in zip(hist, want):
        assert all(got[k] == float(v) for k, v in w.items())  # bit-equal
        assert (got["lr"], got["momentum"]) == (lr(got["step"]),
                                                mom(got["step"]))
    sa, sb = state.model.state_dict(), ref.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sb)
    oa, ob = state.optimizer.state_dict(), ref.optimizer.state_dict()
    assert sorted(oa["state"]) == sorted(ob["state"]) and oa["state"]
    for k, s in ob["state"].items():
        assert sorted(oa["state"][k]) == sorted(s) == [
            "exp_avg", "exp_avg_sq", "step"]
        assert all(torch.equal(oa["state"][k][n], s[n]) for n in s)
