"""The train CLI over two ranks on the CPU (``torch_dp.cli_ranks``: each
rank a process with the environment a launcher gives it): on synthetic
data at --batch 1 a rank, step 1's losses are those of one process at
--batch 2, only rank 0 writes the checkpoint and log.txt, --resume
restores every rank; meshes that do not cover two processes (or name
another axis) and --device-cache over two processes are refused. Width
sharding from files, --mesh model=2 --gspmd-width under the launcher
(``chip_smoke.launch_cli_ranks``): both ranks train on the frames the
first one loads, end bit-equal, and validate on whole frames."""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from rangedet_tpu_torch.data.synthetic import write_waymo_files
from rangedet_tpu_torch.tools import train as train_cli
from test_torch_train import LOSS_TOL
from torch_dp import cli_ranks, tiny_recipe

torch.set_num_threads(1)
NAME = "rangedet_veh_wo_aug_4_18e"  # the tiny recipe's name


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    return tiny_recipe(tmp_path_factory.mktemp("dp_cli"))


@pytest.fixture(scope="module")
def synthetic(recipe, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_synthetic")
    common = ["--config", str(recipe), "--synthetic", "--steps-per-epoch",
              "2", "--device", "cpu", "--num-workers", "1"]
    one, _, _ = train_cli.main(common + [
        "--batch", "2", "--epochs", "1", "--experiment-dir",
        str(tmp / "one")])
    exp = ["--batch", "1", "--experiment-dir", str(tmp / "two")]
    first, logs = cli_ranks(tmp, "first", "train",
                        common + exp + ["--epochs", "1", "--mesh", "data=2"])
    resumed, _ = cli_ranks(tmp, "resumed", "train",
                       common + exp + ["--epochs", "2", "--resume"])
    return dict(one=one, first=first, logs=logs, resumed=resumed,
                run_dir=tmp / "two" / NAME)


def test_two_ranks_step_one_losses_are_one_process_at_twice_the_batch(
        synthetic):
    want = synthetic["one"][0]
    for out in synthetic["first"]:
        got = out["hist"][0]
        assert got["lr"] == want["lr"]  # auto_scale_lr: the global batch
        for k in want:
            if "loss" in k:
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           **LOSS_TOL)


def test_only_rank_zero_writes_the_checkpoint_and_the_log(synthetic):
    a, b = synthetic["first"]
    assert a["saved"] == [0] and b["saved"] == []
    assert sorted(os.listdir(synthetic["run_dir"] / "checkpoints")) == [
        "torch_epoch_0000.pt", "torch_epoch_0001.pt"]
    log = (synthetic["run_dir"] / "log.txt").read_text()
    assert "rank 0 on cpu" in log and "rank 1 on" not in log
    assert "2 rank(s), gloo" in synthetic["logs"][1]


def test_resume_restores_every_rank(synthetic):
    for resumed in synthetic["resumed"]:
        assert [h["step"] for h in resumed["hist"]] == [2, 3]
        assert resumed["step"] == 4
    a, b = synthetic["resumed"]
    assert all(torch.equal(v, b["state"][k]) for k, v in a["state"].items())
    for ha, hb in zip(a["hist"], b["hist"]):  # the losses are the group's
        assert {k: v for k, v in ha.items() if "loss" in k} == {
            k: v for k, v in hb.items() if "loss" in k}


@pytest.mark.parametrize("flags,message", [
    (["--mesh", "model=4"], "world size"),
    (["--mesh", "data=2,model=2"], "world size"),
    (["--gspmd-width", "--mesh", "data=1,pipe=2"], "axes"),
    (["--mesh", "data=4"], "world size"),
    (["--device-cache", "--data-root", "x"], "single-process"),
])
def test_refused_over_two_processes(recipe, monkeypatch, flags, message):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=message):
        train_cli.main(["--config", str(recipe), "--device", "cpu"]
                       + flags)


@pytest.fixture(scope="module")
def width_run(recipe, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("width_cli")
    data = str(tmp / "data")
    write_waymo_files(data, 4, H=16, W=128, image_set="training")
    write_waymo_files(data, 1, H=16, W=128, image_set="validation")
    return chip_smoke.launch_cli_ranks(str(tmp), "width", 2, [
        "--config", str(recipe), "--data-root", data, "--sampling-rate", "1",
        "--batch", "1", "--steps-per-epoch", "2", "--epochs", "1",
        "--num-workers", "1", "--device", "cpu", "--experiment-dir",
        str(tmp / "exp"), "--mesh", "model=2", "--gspmd-width",
        "--eval-every", "1", "--eval-frames", "1"])


def test_width_ranks_train_on_the_first_ranks_frames(width_run):
    (a, b), log = width_run
    # the put shares each batch it puts: the epoch's 2 steps' and the
    # PREFETCH_DEPTH - 1 put ahead of them
    assert len(a["shared"]) == 2 + train_cli.PREFETCH_DEPTH - 1
    assert a["shared"] == b["shared"]
    frames = [[u for u in o["mapped"] if "/training/" in u] for o in (a, b)]
    assert frames[0] and not frames[1]  # rank 1 receives, loads none
    assert [h["step"] for h in a["hist"]] == [0, 1]
    for ha, hb in zip(a["hist"], b["hist"]):  # the losses are the world's
        assert {k: v for k, v in ha.items() if "loss" in k} == {
            k: v for k, v in hb.items() if "loss" in k}
    assert all(torch.equal(v, b["state"][k]) for k, v in a["state"].items())
    assert a["saved"] == [0] and b["saved"] == []
    assert "width sharding: mesh data=1,model=2" in log
    assert "--gspmd-width: no auto-partitioner" in log


def test_width_ranks_validate_whole_frames(width_run):
    (a, b), _ = width_run
    assert a["val"] == b["val"] and sorted(a["val"]) == [0]
    assert all(np.isfinite(x) for x in a["val"][0]["veh"].values())
