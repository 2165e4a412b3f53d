"""The sketch's semantics in plain NumPy and torch, frozen for the benchmark.

What the reference computes, written from the port's plain versions as
they stood when the benchmark was defined (`core/hashing.py`,
`core/prng.py`, `core/counters.py`, `core/sketch.py`, `core/topk.py`,
`kernels/ref.py`), in one file that imports nothing of the program:

  * hashing: d seeded murmur3 fmix32 hashes of a uint32 key, one column
    a row;
  * uniforms: threefry-2x32 on the raw key (seed, flush#), element i of
    a (total, n) grid at flat index row * n + col (JAX's partitionable
    draw, bit for bit);
  * a flush: per row, a stable sort of the keys with each key's weight
    summed at its first slot, then the conservative update in
    CHUNK-sized slices of the sorted keys: every key of a slice reads
    the row minima from before the slice, its new state is `nfold` of
    the minimum by its weight with the uniform of its sorted slot, and
    writes resolve by max;
  * a log counter's `nfold` and decode: the jitted float32 graph
    (`reference/f32.py`); a linear counter's: integers;
  * the heavy-hitter heap: the standing heap joined with the batch, each
    candidate scored against the updated row, deduplicated (valid
    entries first among equal keys) and the best K kept in a stable
    descending order;
  * a window read: per bucket in ascending order, decode(min) times the
    bucket's weight, summed.

Cells are int64 values; keys int64 holding uint32 bits.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from reference import f32
from reference import nfold as nf

MASK32 = 0xFFFF_FFFF
CHUNK = 1024                # keys per sequential update slice
_C1, _C2, _GOLDEN = 0x85EB_CA6B, 0xC2B2_AE35, 0x9E37_79B1
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD1_1BDA


# ---- hashing ---------------------------------------------------------------

def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    return x ^ (x >> 16)


def row_seeds(seed: int, depth: int) -> list:
    def fmix(x: int) -> int:
        x ^= x >> 16
        x = (x * _C1) & MASK32
        x ^= x >> 13
        x = (x * _C2) & MASK32
        return x ^ (x >> 16)
    s = seed & MASK32
    return [fmix(((i * _GOLDEN) & MASK32) ^ s) for i in range(1, depth + 1)]


def row_hashes(keys: torch.Tensor, seeds, width: int) -> torch.Tensor:
    """(d, ..., N) int64 columns of int64 keys (..., N)."""
    s = torch.tensor(seeds, dtype=torch.int64, device=keys.device)
    s = s.reshape((-1,) + (1,) * keys.dim())
    return mix32(keys.unsqueeze(0) ^ s) % int(width)


def row_hashes_np(keys: np.ndarray, seeds, width: int) -> np.ndarray:
    """`row_hashes` on NumPy int64 keys."""
    x = keys[None].astype(np.uint64) ^ np.asarray(
        seeds, np.uint64).reshape((-1,) + (1,) * keys.ndim)
    m = np.uint64(MASK32)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(_C1)) & m
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(_C2)) & m
    x ^= x >> np.uint64(16)
    return (x % np.uint64(width)).astype(np.int64)


# ---- uniforms --------------------------------------------------------------

def threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """20 rounds on uint32 counter arrays (sums wrap at 2^32)."""
    u = np.uint32
    ks = (u(k1), u(k2), u(k1 ^ k2 ^ _PARITY))
    with np.errstate(over="ignore"):
        x1 = x1 + ks[0]
        x2 = x2 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x1 += x2
                x2 = ((x2 << u(r)) | (x2 >> u(32 - r))) ^ x1
            x1 += ks[(i + 1) % 3]
            x2 += ks[(i + 2) % 3] + u(i + 1)
    return x1, x2


def uniform_rows(key, total: int, n_cols: int, rows) -> np.ndarray:
    """Rows `rows` of the (total, n_cols) float32 draw of raw key `key`."""
    rows = np.asarray(rows, np.int64)
    assert rows.max() < total
    idx = rows[:, None] * n_cols + np.arange(n_cols)[None]
    b1, b2 = threefry2x32(int(key[0]) & MASK32, int(key[1]) & MASK32,
                          (idx >> 32).astype(np.uint32),
                          (idx & MASK32).astype(np.uint32))
    bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F80_0000)
    return bits.view(np.float32) - np.float32(1.0)


# ---- counters --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Counter:
    kind: str       # "log" or "linear"
    base: float
    bits: int

    @property
    def max_state(self) -> int:
        return (1 << self.bits) - 1

    @property
    def logb(self) -> float:
        return float(np.float32(math.log(self.base)))

    @property
    def bm1(self) -> float:
        return float(np.float32(self.base - 1.0))

    def _table(self, which: str, device) -> torch.Tensor:
        key = (self, which, str(device))
        t = _TABLES.get(key)
        if t is None:
            size = math.ceil(88.8 / self.logb) + 2
            s = torch.arange(size, dtype=torch.float32, device=device)
            fn = f32.morris_em if which == "em" else f32.morris_ep
            t = _TABLES[key] = fn(s, self.logb)
        return t

    def _states(self, s: torch.Tensor, which: str) -> torch.Tensor:
        t = self._table(which, s.device)
        return t[s.clamp(0, t.numel() - 1).to(torch.int64)]

    def decode(self, state: torch.Tensor) -> torch.Tensor:
        s = state.to(torch.float32)
        if self.kind == "linear":
            return s
        return self._states(s, "em") * torch.tensor(
            f32.recip(self.bm1), dtype=torch.float32, device=s.device)

    def decode_scaled(self, state: torch.Tensor, w: torch.Tensor):
        s = state.to(torch.float32)
        w = f32.flush(w.to(torch.float32))
        if self.kind == "linear":
            return f32.flush(s * w)
        scale = f32.flush(w * torch.tensor(f32.recip(self.bm1),
                                           dtype=torch.float32,
                                           device=w.device))
        return f32.flush(self._states(s, "em") * scale)

    def nfold_np(self, state: np.ndarray, n: np.ndarray, uniform: np.ndarray
                 ) -> np.ndarray:
        """`nfold` on NumPy arrays: int64 states -> int64 new states."""
        n = n.astype(np.float32)
        if self.kind == "linear":
            n_int = np.floor(n)
            bump = (uniform < n - n_int).astype(np.int64)
            room = self.max_state - state
            add = np.minimum(n_int, np.float32(2147483648.0)).astype(np.int64)
            return state + np.minimum(add + bump, room)
        em, ep = (self._table(w, "cpu").numpy() for w in ("em", "ep"))

        def gather(t):
            return lambda c: t[np.clip(c, 0, t.size - 1).astype(np.int64)]
        return nf.nfold(state.astype(np.float32), n, uniform, self.logb,
                        self.bm1, self.max_state, gather(em),
                        gather(ep)).astype(np.int64)


_TABLES: dict = {}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One sketch: width columns, depth rows, its hash seed and cells."""
    width: int
    depth: int
    seed: int
    counter: Counter

    @property
    def seeds(self) -> list:
        return row_seeds(self.seed, self.depth)


# ---- flush -----------------------------------------------------------------

def dedup_weighted(keys: np.ndarray, weights: np.ndarray):
    """(sorted keys, each key's summed weight at its first slot, else 0),
    row by row of (R, N) int64 keys and float32 weights."""
    order = np.argsort(keys, axis=-1, kind="stable")
    sorted_keys = np.take_along_axis(keys, order, -1)
    w = np.take_along_axis(weights.astype(np.float32), order, -1)
    start = np.ones(sorted_keys.shape, bool)
    start[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    seg = np.cumsum(start, axis=-1) - 1
    totals = np.zeros_like(w)
    rows = np.arange(keys.shape[0])[:, None]
    np.add.at(totals, (np.broadcast_to(rows, seg.shape), seg), w)
    mult = np.where(start, np.take_along_axis(totals, seg, -1),
                    np.float32(0.0))
    return sorted_keys, mult


def update(cells: torch.Tensor, keys: torch.Tensor, weights: torch.Tensor,
           uniforms: np.ndarray, geo: Geometry) -> None:
    """The conservative update of R rows (R, d, w) (int64, on the host)
    by raw batches keys / weights (R, N), uniforms (R, N) by sorted
    slot, in place: CHUNK-sized slices of the sorted keys, each reading
    the minima from before the slice, writes resolving by max.  A slot
    of weight 0 (a duplicate, or past the fill) writes 0, which the max
    ignores, so only the weighted slots are computed."""
    c = cells.numpy()
    r, d, w = c.shape
    flat = cells.view(-1)
    sorted_keys, mult = dedup_weighted(keys.numpy(), weights.numpy())
    di = np.arange(d)[:, None]
    seeds = geo.seeds
    for lo in range(0, keys.shape[-1], CHUNK):
        rr, jj = np.nonzero(mult[:, lo:lo + CHUNK] > 0)
        jj = jj + lo
        cols = row_hashes_np(sorted_keys[rr, jj], seeds, w)      # (d, S)
        cmin = c[rr[None], di, cols].min(axis=0)
        new = geo.counter.nfold_np(cmin, mult[rr, jj], uniforms[rr, jj])
        idx = (rr[None] * d + di) * w + cols
        flat.scatter_reduce_(0, torch.from_numpy(idx.reshape(-1)),
                             torch.from_numpy(np.tile(new, d)),
                             reduce="amax")


def states_at(cells: torch.Tensor, keys: torch.Tensor, geo: Geometry):
    """(R, N) min-over-rows states of rows (R, d, w) at keys (R, N)."""
    cols = row_hashes(keys, geo.seeds, cells.shape[-1])
    r, d = cells.shape[0], cells.shape[1]
    ri = torch.arange(r, device=cells.device).reshape(1, -1, 1)
    di = torch.arange(d, device=cells.device).reshape(-1, 1, 1)
    return cells[ri, di, cols].min(dim=0).values


def query(cells: torch.Tensor, keys: torch.Tensor, geo: Geometry):
    """float32 (R, N) estimates of rows (R, d, w) at keys (R, N)."""
    return geo.counter.decode(states_at(cells, keys, geo))


def window_query(rings: torch.Tensor, keys: torch.Tensor,
                 weights: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """float32 (R, N): rings (R, B, d, w), keys (R, N), weights (R, B);
    bucket b's decode(min) * weight, summed from bucket 0 upward."""
    out = None
    for b in range(rings.shape[1]):
        est = geo.counter.decode_scaled(states_at(rings[:, b], keys, geo),
                                        weights[:, b:b + 1])
        out = est if out is None else out + est
    return out


# ---- heavy hitters ---------------------------------------------------------

def select(cand: torch.Tensor, valid: torch.Tensor, est: torch.Tensor,
           k: int):
    """(keys int64, estimates, filled), each (R, k), of candidate unions
    (R, M)."""
    neg_inf = torch.full_like(est, -torch.inf)
    est = torch.where(valid, est, neg_inf)
    o1 = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(cand, -1, o1), dim=-1, stable=True).indices
    order = torch.gather(o1, -1, o2)
    sk = torch.gather(cand, -1, order)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[..., 1:] = sk[..., 1:] != sk[..., :-1]
    keep = torch.zeros_like(first).scatter_(-1, order, first)
    est = torch.where(keep, est, neg_inf)
    top, idx = torch.sort(est, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    return torch.gather(cand, -1, idx), top, top > -torch.inf


# ---- window ----------------------------------------------------------------

def rotation_mask(cursor: int, steps: int, buckets: int) -> np.ndarray:
    """(B,) buckets a rotation of `steps` clears after `cursor`."""
    off = (np.arange(buckets) - cursor - 1) % buckets
    return (off < steps) | (steps >= buckets)


def full_window_weights(cursor: int, buckets: int) -> np.ndarray:
    ages = (cursor - np.arange(buckets)) % buckets
    return (ages < buckets).astype(np.float32)
