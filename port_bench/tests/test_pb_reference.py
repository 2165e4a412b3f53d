"""The frozen reference against the port's plain engine on the CPU: the
whole run of each cell at a tiny size, and its parts bit for bit."""
import numpy as np
import pytest
import torch

from conftest import MIXES, tiny
from harness import runner
from reference import sketch as rs
from repro_torch.core import CMLS16, CMS32, prng
from repro_torch.core import sketch as psk
from repro_torch.core.hashing import host_row_seeds, row_hashes


@pytest.mark.parametrize("cell", MIXES)
def test_run_is_correct_against_the_plain_engine(cell):
    out = runner.run(tiny(cell), 2**31 + 99, 0.05, False, 0.0, device="cpu")
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("counter", [CMLS16, CMS32])
def test_nfold_bit_for_bit(counter):
    g = torch.Generator().manual_seed(5)
    state = torch.randint(0, 30_000 if counter is CMLS16 else 2**20, (4096,),
                          generator=g)
    n = torch.randint(0, 40, (4096,), generator=g).to(torch.float32)
    u = torch.rand(4096, generator=g)
    want = counter.nfold(state, n, u).numpy()
    mine = rs.Counter(counter.kind, counter.base, counter.bits).nfold_np(
        state.numpy(), n.numpy(), u.numpy())
    assert np.array_equal(mine, want)


def test_uniforms_and_hashes_bit_for_bit():
    key = np.array([2**31 + 7, 11], np.uint32)
    want = prng.uniform_rows(key, 9, 3000, [0, 4, 8]).numpy()
    mine = rs.uniform_rows(key, 9, 3000, [0, 4, 8])
    assert np.array_equal(mine.view(np.int32), want.view(np.int32))
    keys = torch.randint(0, 2**32, (2, 500), dtype=torch.int64)
    assert list(host_row_seeds(0x5EED, 2)) == rs.row_seeds(0x5EED, 2)
    seeds = torch.tensor(rs.row_seeds(0x5EED, 2))
    assert np.array_equal(rs.row_hashes_np(keys.numpy(), rs.row_seeds(
        0x5EED, 2), 4096), row_hashes(keys, seeds, 4096).numpy())


def test_dedup_bit_for_bit():
    keys = torch.randint(0, 50, (3, 700), dtype=torch.int64)
    w = (torch.rand(3, 700) < 0.8).to(torch.float32)
    sk, m = psk.dedup_weighted(keys, w)
    mk, mm = rs.dedup_weighted(keys.numpy(), w.numpy())
    assert np.array_equal(sk.numpy(), mk) and np.array_equal(m.numpy(), mm)
