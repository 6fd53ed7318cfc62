"""The CLIs over two ranks from dataset files on the CPU
(``torch_dp.cli_ranks``: each rank a process with the environment a
launcher gives it): in tools.train each rank maps its own frames, which
cover the split once in an epoch (not the reference's loader fault, where
every host loads the global batch from its own partition); tools.test
writes the one-process pickle, rank 0 gathering the frames the ranks ran
in turn."""
import pickle

import numpy as np
import pytest
import torch

from rangedet_tpu_torch.data.synthetic import write_waymo_files
from rangedet_tpu_torch.tools import test as test_cli
from torch_dp import cli_ranks, tiny_recipe

torch.set_num_threads(1)


@pytest.fixture
def recipe(tmp_path):
    return tiny_recipe(tmp_path)


def test_ranks_map_disjoint_frames_that_cover_the_split(recipe,
                                                        tmp_path):
    recs = write_waymo_files(str(tmp_path / "data"), 8, H=16, W=128,
                             image_set="training")
    outs, _ = cli_ranks(tmp_path, "files", "train", [
        "--config", str(recipe), "--data-root", str(tmp_path / "data"),
        "--sampling-rate", "1", "--batch", "1", "--epochs", "1",
        "--num-workers", "1", "--device", "cpu", "--checkpoint-every", "0",
        "--experiment-dir", str(tmp_path / "exp")])
    a, b = (o["mapped"] for o in outs)
    assert len(outs[0]["hist"]) == 4  # 8 frames, 1 a step on 2 ranks
    assert len(a) == len(set(a)) == 4 and len(b) == len(set(b)) == 4
    assert sorted(a + b) == sorted(r["pc_url"] for r in recs)


def test_test_cli_over_two_ranks_writes_the_one_process_pickle(recipe,
                                                              tmp_path):
    write_waymo_files(str(tmp_path / "data"), 5, H=16, W=128,
                      image_set="validation")
    argv = ["--config", str(recipe), "--data-root", str(tmp_path / "data"),
            "--image-set", "validation", "--batch", "1", "--device", "cpu",
            "--experiment-dir", str(tmp_path / "exp")]
    one = test_cli.main(argv + ["--output", str(tmp_path / "one.pkl")])
    outs, _ = cli_ranks(tmp_path, "test", "test",
                    argv + ["--output", str(tmp_path / "two.pkl")])
    assert outs[0]["path"] == str(tmp_path / "two.pkl")
    assert outs[1]["path"] is None
    with open(one, "rb") as f:
        want = [pickle.load(f), pickle.load(f)]
    with open(outs[0]["path"], "rb") as f:
        got = [pickle.load(f), pickle.load(f)]
    assert len(want[1]) == 5
    assert identical(got, want)  # every frame once, in one order


def identical(a, b) -> bool:
    """The same structure, keys in the same order, arrays of the same
    dtype, shape and bytes, every other value equal."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(identical(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(identical, a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b
