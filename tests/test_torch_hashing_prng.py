"""The port's hashing and threefry uniforms against the JAX package, bit for bit.

Keys are made with numpy from a fixed seed and handed to both packages;
every output is compared as raw uint32 bits.
"""
import jax
import jax.extend.random as jer
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.kernels import ops as jops
from repro_torch.core import hashing as th
from repro_torch.core import prng
from repro_torch.kernels import ops as tops


def _keys(n=4096, seed=0):
    k = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    k = k.astype(np.uint32)
    k[:4] = [0, 0xFFFF_FFFF, 1, 0x8000_0000]
    return k


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_mix32_bit_equal():
    k = _keys()
    assert np.array_equal(np.asarray(jh.mix32(jnp.asarray(k))),
                          th.mix32(_t(k)).numpy().astype(np.uint32))


@pytest.mark.parametrize("seed,depth", [(0, 1), (0x5EED, 2),
                                        (0xFFFF_FFFF, 5), (2**40 + 7, 3)])
def test_row_seeds_bit_equal(seed, depth):
    want = np.asarray(jh.make_row_seeds(seed, depth))
    assert np.array_equal(th.make_row_seeds(seed, depth).numpy(), want)
    assert th.host_row_seeds(seed, depth) == jh.host_row_seeds(seed, depth)


@pytest.mark.parametrize("width", [7, 1000, 1 << 20])
def test_row_hashes_bit_equal(width):
    k = _keys()
    seeds = jh.make_row_seeds(0x5EED, 3)
    want = np.asarray(jh.row_hashes(jnp.asarray(k), seeds, width))
    got = th.row_hashes(_t(k), th.make_row_seeds(0x5EED, 3), width)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_combine2_and_fold_ngram_bit_equal():
    a, b = _keys(seed=1), _keys(seed=2)
    assert np.array_equal(
        np.asarray(jh.combine2(jnp.asarray(a), jnp.asarray(b))),
        th.combine2(_t(a), _t(b)).numpy())
    toks = np.stack([_keys(512, s) for s in range(4)], axis=1)
    assert np.array_equal(np.asarray(jh.fold_ngram(jnp.asarray(toks))),
                          th.fold_ngram(_t(toks)).numpy())


def test_threefry2x32_matches_jax_including_high_counter_words():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, (2, 257), dtype=np.uint64).astype(np.uint32)
    x[0, :3] = [0, 0xFFFF_FFFF, 1]
    key = np.asarray([0xDEAD_BEEF, 12345], np.uint32)
    want = np.asarray(jer.threefry_2x32(jnp.asarray(key),
                                        jnp.asarray(x.reshape(-1))))
    b1, b2 = prng.threefry2x32(int(key[0]), int(key[1]), _t(x[0]), _t(x[1]))
    got = np.concatenate([b1.numpy(), b2.numpy()]).astype(np.uint32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape,key", [
    ((1,), (0, 0)), ((3, 7), (0xFFFF_FFFF, 12)), ((64, 1024), (0, 5)),
    ((2, 3, 5), (1, 0xFFFF_FFFF)), ((17, 129), (0x5EED, 41))])
def test_uniform_bit_equal(shape, key):
    want = np.asarray(jax.random.uniform(np.asarray(key, np.uint32), shape))
    got = prng.uniform(key, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("total,n_cols,rows", [
    (6, 2048, [1, 4, 5]), (3, 1, [2]), (9, 1031, [0, 8, 3]),
    (5, 4096, [])])
def test_parity_uniform_rows_bit_equal(total, n_cols, rows):
    key = np.asarray([1, 9], np.uint32)
    want = np.asarray(jops._parity_uniforms(
        key, n_cols, total, np.asarray(rows, np.int32)))
    got = tops._parity_uniforms(key, n_cols, total, rows, "cpu").numpy()
    assert got.shape == want.shape == (len(rows), n_cols)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_rows_rejects_rows_outside_the_grid():
    with pytest.raises(ValueError):
        prng.uniform_rows([0, 0], 4, 8, [4])
