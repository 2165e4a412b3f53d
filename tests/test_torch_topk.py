"""The port's heavy-hitter tracker against the JAX package, exactly.

`jnp.lexsort` in the reference's `_select` becomes two stable sorts, and
`jax.lax.top_k` (lower index first among ties) becomes a stable
descending sort, so the selected keys, their order and the occupancy
mask match bit for bit, ties, key 0, key 0xFFFFFFFF and unfilled slots
included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as jtk
from repro_torch.core import counters as tc
from repro_torch.core import topk as ttk


def _t(a):
    return tc.from_numpy(np.asarray(a), "cpu")


def _tracker(seed, t=3, k=6):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 6, (t, k)).astype(np.uint32)
    keys[0, :2] = [0, 0xFFFF_FFFF]
    filled = rng.random((t, k)) < 0.6
    est = np.where(filled, rng.integers(0, 4, (t, k)), -np.inf).astype(
        np.float32)
    keys[~filled] = 0  # cold slots hold key-0 placeholders
    return keys, est, filled


def _both(keys, est, filled):
    return (jtk.TopK(jnp.asarray(keys), jnp.asarray(est), jnp.asarray(filled)),
            ttk.TopK(_t(keys), _t(est), _t(filled)))


@pytest.mark.parametrize("seed", range(6))
def test_candidates_and_reselect_exact(seed):
    keys, est, filled = _tracker(seed)
    jt, tt = _both(keys, est, filled)
    rng = np.random.default_rng(100 + seed)
    batch = rng.integers(0, 6, (3, 10)).astype(np.uint32)
    batch[1, :3] = [0xFFFF_FFFF, 0, 0]
    valid = rng.random((3, 10)) < 0.7
    jc_, jv = jtk.candidates(jt, jnp.asarray(batch), jnp.asarray(valid))
    tc_, tv = ttk.candidates(tt, _t(batch), _t(valid))
    assert np.array_equal(tc.to_numpy(tc_), np.asarray(jc_))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    # many tied scores: only 3 distinct values over 16 candidates
    score = rng.integers(0, 3, jc_.shape).astype(np.float32)
    for k in (1, 4, 6):
        want = jtk.reselect(jc_, jv, jnp.asarray(score), k)
        got = ttk.reselect(tc_, tv, _t(score), k)
        assert np.array_equal(tc.to_numpy(got.keys), np.asarray(want.keys))
        assert np.array_equal(got.estimates.numpy(),
                              np.asarray(want.estimates))
        assert np.array_equal(got.filled.numpy(), np.asarray(want.filled))


def test_unfilled_slot_never_shadows_key_zero():
    keys = np.zeros((1, 4), np.uint32)
    est = np.full((1, 4), -np.inf, np.float32)
    filled = np.zeros((1, 4), bool)
    jt, tt = _both(keys, est, filled)
    batch = np.asarray([[0, 0xFFFF_FFFF, 7]], np.uint32)
    jc_, jv = jtk.candidates(jt, jnp.asarray(batch), None)
    tc_, tv = ttk.candidates(tt, _t(batch), None)
    score = np.asarray([[9, 9, 9, 9, 5, 3, 5]], np.float32)
    want = jtk.reselect(jc_, jv, jnp.asarray(score), 4)
    got = ttk.reselect(tc_, tv, _t(score), 4)
    assert tc.to_numpy(got.keys).tolist() == np.asarray(want.keys).tolist()
    assert got.estimates.numpy().tolist() == [[5.0, 5.0, 3.0, -np.inf]]
    assert got.filled.numpy().tolist() == np.asarray(want.filled).tolist()


def test_refresh_stacked_matches():
    keys, est, filled = _tracker(7, t=2, k=4)
    jt, tt = _both(keys, est, filled)
    batch = np.asarray([[3, 3, 1, 0xFFFF_FFFF], [2, 5, 5, 5]], np.uint32)

    def score_j(ck):
        return (ck % 4).astype(jnp.float32)

    def score_t(ck):
        return (tc.to_i64(ck) % 4).to(torch.float32)

    want = jtk.refresh_stacked(jt, jnp.asarray(batch), None, score_j)
    got = ttk.refresh_stacked(tt, _t(batch), None, score_t)
    assert np.array_equal(tc.to_numpy(got.keys), np.asarray(want.keys))
    assert np.array_equal(got.estimates.numpy(), np.asarray(want.estimates))
    assert np.array_equal(got.filled.numpy(), np.asarray(want.filled))


def test_init_stacked_matches():
    j = jtk.init_stacked(3, 5)
    t = ttk.init_stacked(3, 5, device="cpu")
    assert np.array_equal(tc.to_numpy(t.keys), np.asarray(j.keys))
    assert np.array_equal(t.estimates.numpy(), np.asarray(j.estimates))
    assert np.array_equal(t.filled.numpy(), np.asarray(j.filled))
