"""Vectorized hash families for sketch row indexing.

PyTorch counterpart of `repro/core/hashing.py`: a murmur3 fmix32
finalizer seeded per row.  torch has no uint32 `>>`, `%` or min/max on
the CPU, so keys are carried as int64 values masked to 32 bits, and each
32-bit multiply is split into two 16-bit halves so no int64 product ever
overflows.  Bit-identical to the reference for every uint32 key.
"""
from __future__ import annotations

import torch

from repro_torch.core.counters import MASK32, to_i64

_C1 = 0x85EB_CA6B
_C2 = 0xC2B2_AE35
_GOLDEN = 0x9E37_79B1  # 2^32 / phi, odd


def as_i64(x: torch.Tensor) -> torch.Tensor:
    """Any integer key tensor -> int64 holding its uint32 bits."""
    if x.dtype in (torch.uint8, torch.uint16, torch.uint32):
        return to_i64(x)
    return x.to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 finalizer on uint32 values carried as int64."""
    x = as_i64(x)
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def make_row_seeds(seed: int, depth: int, device="cpu") -> torch.Tensor:
    """Derive `depth` independent row seeds (int64 uint32 values)."""
    base = mul32(torch.arange(1, depth + 1, dtype=torch.int64,
                              device=device), _GOLDEN)
    return mix32(base ^ (seed & MASK32))


def host_row_seeds(seed: int, depth: int) -> tuple:
    """`make_row_seeds` as plain Python ints (what the kernels take)."""
    def fmix(x: int) -> int:
        x ^= x >> 16
        x = (x * _C1) & MASK32
        x ^= x >> 13
        x = (x * _C2) & MASK32
        x ^= x >> 16
        return x

    s = seed & MASK32
    return tuple(fmix(((i * _GOLDEN) & MASK32) ^ s)
                 for i in range(1, depth + 1))


def row_hashes(keys: torch.Tensor, row_seeds: torch.Tensor, width: int
               ) -> torch.Tensor:
    """Hash keys into every sketch row.

    keys: (..., N) integer keys (reinterpreted as uint32); row_seeds: (d,)
    int64 seeds.  Returns (d, ..., N) int64 column indices in [0, width).
    """
    k = as_i64(keys)
    seeds = row_seeds.to(k.device).reshape((-1,) + (1,) * k.dim())
    return mix32(k.unsqueeze(0) ^ seeds) % int(width)


def combine2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two uint32 keys into one (bigrams / feature crosses)."""
    a = as_i64(a)
    b = as_i64(b)
    return mix32((mul32(a, _GOLDEN) + mix32(b ^ _C1)) & MASK32)


def fold_ngram(tokens: torch.Tensor) -> torch.Tensor:
    """Fold an (N, n) array of token-id n-grams into (N,) uint32 keys."""
    key = as_i64(tokens[:, 0])
    for i in range(1, tokens.shape[1]):
        key = combine2(key, tokens[:, i])
    return key
