"""The faults of ``portbench/faults.py`` planted on every rank of the
data-parallel path (``veh.train.dp4`` of ``dp_cell.py``, two gloo ranks,
the tiny size, on the CPU): each has to turn ``correct`` false."""
import pytest
import torch

from portbench import faults

from dp_cell import dp_checkout, dp_run

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return dp_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("name", sorted(faults.TRAIN))
def test_train_faults_are_caught(bench, name):
    """Each fault planted on every rank: the exchange left out, half of
    each rank's rows left out, the state left unchanged."""
    out = dp_run(bench, fault=name)
    assert out["result"]["correct"] is False
    if name == "no_exchange":  # rank 0's own part of the loss
        assert out["checks"]["loss1_gap"][0] > out["checks"]["loss1_gap"][1]
