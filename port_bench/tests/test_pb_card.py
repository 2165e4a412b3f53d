"""Each cell on the card at its own size: a short run is correct and
reports its metrics (skips where there is no CUDA card)."""
import json
import subprocess
import sys

import pytest

from conftest import BENCH, CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", "2718281828", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert "setup_s" in out["metrics"]
