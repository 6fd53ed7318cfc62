"""The train CLI over two ranks on the CPU (``torch_dp.cli_ranks``: each
rank a process with the environment a launcher gives it): on synthetic
data at --batch 1 a rank, step 1's losses are those of one process at
--batch 2, only rank 0 writes the checkpoint and log.txt, --resume
restores every rank; --mesh model=2, --gspmd-width and --device-cache over
two processes are refused."""
import os

import numpy as np
import pytest
import torch

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
    (["--mesh", "model=2"], "ROADMAP #16 part 2"),
    (["--mesh", "data=2,model=2"], "ROADMAP #16 part 2"),
    (["--gspmd-width"], "ROADMAP #16 part 2"),
    (["--mesh", "data=4"], "world size"),
    (["--device-cache", "--data-root", "x"], "single-process"),
])
def test_refused_over_two_processes(recipe, monkeypatch, flags, message):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=message):
        train_cli.main(["--config", str(recipe), "--device", "cpu"]
                       + flags)
