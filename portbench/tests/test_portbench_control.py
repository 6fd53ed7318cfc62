"""The control of ``correct`` on the card, at the cells' own sizes: the
reference computed in fp8 in the program's place has to fail the limits
the configuration files set, where the program passes them
(``portbench.calibrate`` reads the same numbers over many seeds)."""
import pytest

from portbench import calibrate, run

CELLS = ["veh.train.b8", "tpuopt.train.b2", "veh.eval.b4"]
SEED = 2 ** 31 + 101


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cuda_card, cell):
    _, _, config, traffic = run.load_spec(cell)
    limits = config["limits"][traffic["mode"]]
    ctl = calibrate.control_numbers(cell, SEED)
    assert any(v > limits[k] for k, v in ctl.items()), ctl
    out = run.run_cell(cell, SEED, 4.0, False)
    assert out["result"]["correct"], out["checks"]
