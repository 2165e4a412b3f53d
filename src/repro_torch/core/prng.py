"""Threefry-2x32 uniforms, bit-identical to `jax.random.uniform` on raw keys.

The counting service draws each flush epoch's stochastic-rounding
uniforms from the raw key (seed, flush#).  With JAX's partitionable
threefry scheme, element i of a draw of `shape` is

    hi, lo = i >> 32, i & 0xFFFFFFFF          # i = flat row-major index
    b1, b2 = threefry2x32((k1, k2), (hi, lo))
    bits   = b1 ^ b2
    u      = float32((bits >> 9) | 0x3F800000) - 1.0

which is pure integer work, so it is reproduced here bit for bit with
int64 tensor ops on the caller's device (no host round trip).  `rows`
draws only some rows of a 2-D grid: row r column c takes flat index
r * n_cols + c, exactly the element a full draw gathered at r holds; the
rows' offsets reach the device without a synchronize (`core/staging.py`).

`split(key, num)` is `jax.random.split` on a raw key under the same
scheme: key i is the pair threefry2x32(key, (0, i)), computed on the host
(num is small and the keys feed host-side draws).  `randint` is
`jax.random.randint` on a raw key (int32), from two `random_bits` draws.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import staging
from repro_torch.core.counters import MASK32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD1_1BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """20-round threefry2x32 of the counter pairs (x1, x2) (int64 tensors
    holding uint32 values) under the key (k1, k2)."""
    k1 &= MASK32
    k2 &= MASK32
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    f = (bits >> 9) | 0x3F80_0000
    return f.to(torch.int32).view(torch.float32) - 1.0


def _bits(key, index: torch.Tensor) -> torch.Tensor:
    """The 32 random bits (in int64) at the given flat (int64) draw
    indices of a raw key."""
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    b1, b2 = threefry2x32(int(k[0]), int(k[1]), index >> 32,
                          index & MASK32)
    return b1 ^ b2


def uniform_indices(key, index: torch.Tensor) -> torch.Tensor:
    """float32 uniforms at the given flat (int64) draw indices."""
    return _bits_to_uniform(_bits(key, index))


def uniform(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.uniform(np.asarray(key, np.uint32), shape)`, bit for bit."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return uniform_indices(key, idx).reshape(tuple(shape))


def uniform_rows(key, total: int, n_cols: int, rows, device="cpu"
                 ) -> torch.Tensor:
    """Rows `rows` (host ints) of `uniform(key, (total, n_cols))`, drawn
    directly: (R, n_cols) float32 on `device`."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    if rows.size and (rows.min() < 0 or rows.max() >= total):
        raise ValueError(f"rows must lie in [0, {total})")
    base = staging.upload(device, rows * int(n_cols))[0]
    cols = torch.arange(n_cols, dtype=torch.int64, device=device)
    return uniform_indices(key, base[:, None] + cols[None, :])


def split(key, num: int) -> np.ndarray:
    """`jax.random.split(np.asarray(key, np.uint32), num)`, bit for bit:
    (num, 2) uint32 raw keys."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    k = np.asarray(key, dtype=np.uint32).reshape(2)
    with unset_fake_temporarily():  # host values, also in a fake dry run
        idx = torch.arange(int(num), dtype=torch.int64)
        b1, b2 = threefry2x32(int(k[0]), int(k[1]), idx >> 32, idx & MASK32)
        return torch.stack([b1, b2], dim=1).numpy().astype(np.uint32)


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` on a raw key: an int64 tensor
    of uint32 values."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _bits(key, idx).reshape(tuple(shape))


def randint(key, shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """`jax.random.randint(np.asarray(key, np.uint32), shape, minval,
    maxval)` (int32), bit for bit: jax 0.9.0's `_randint` splits the key
    in two, draws 32 random bits from each half, and folds the pair into
    [minval, maxval) through the span multiplier (2^16 % span)^2 % span,
    every product and sum wrapping at 32 bits as in uint32 (so a span
    above 2^16 gets multiplier 0 and draws `lower % span` alone)."""
    lo32, hi32 = -2**31, 2**31 - 1
    if not (lo32 <= minval <= hi32 and lo32 <= maxval <= hi32):
        raise ValueError("randint bounds must fit in int32")
    k1, k2 = split(key, 2)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (((2**16 % span) ** 2) & MASK32) % span
    # (higher % span) * mult < 2^63: span < 2^32 and mult < span
    off = (((higher % span) * mult) & MASK32) + lower % span
    off = (off & MASK32) % span
    return (off + minval).to(torch.int32)
