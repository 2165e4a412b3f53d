"""The check is shown to fail: the control (the reference in the
program's place with a guarantee broken) and every fault a cell can
have, planted in the program, come out as not correct."""
import pytest

from conftest import MIXES, tiny
from harness import program, runner

SEEDS = (11, 2**31 + 5, 3_000_000_019)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", MIXES)
def test_control_is_not_correct(cell, seed):
    out = runner.run(tiny(cell), seed, 0.05, False, 0.0, device="cpu",
                     control=True)
    assert not out["correct"]
    assert out["checks"]["cells_apart"]["value"] > 0


@pytest.mark.parametrize("fault", program.FAULTS)
@pytest.mark.parametrize("cell", MIXES)
def test_planted_fault_is_caught(cell, fault):
    out = runner.run(tiny(cell), 4242, 0.05, False, 0.0, device="cpu",
                     fault=fault)
    assert not out["correct"], out["checks"]
