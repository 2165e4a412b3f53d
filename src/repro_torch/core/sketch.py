"""Count-Min / Count-Min-Log sketch with conservative update (PyTorch).

Counterpart of `repro/core/sketch.py`: the sketch geometry (`SketchSpec`,
with the packed uint32-lane storage), a `Sketch` holding one (d, w) table,
the paper's query (min over rows + Morris decode), and the two update
paths sharing that table:

  * `update_exact` -- one event at a time, the paper's Algorithm 1 (each
    event sees every earlier update): a plain loop of torch ops, the
    oracle for the batched path;
  * `update_batched` -- sort + segment-sum dedup into (key, multiplicity)
    pairs, n-fold Morris step, conservative write by scatter-max (every
    key reads the minima from before the batch), optionally damped by
    the rows' smallest/second-smallest ratio (`damp_alpha`).

`merge` combines two sketches of one spec cell-wise ("max", or
"estimate_sum" with a stochastic re-encode).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import prng, xla_f32
from repro_torch.core.counters import (CounterSpec, f32_const, from_i64,
                                       pack_table, to_i64, unpack_table,
                                       zeros)
from repro_torch.core.device import resolve_device
from repro_torch.core.hashing import as_i64, make_row_seeds, row_hashes

_KEY_MAX = 0xFFFF_FFFF


def as_uint32_keys(keys) -> np.ndarray:
    """Validate and normalize event/probe keys to a flat uint32 array.

    Floats, negatives, and values past 32 bits are rejected instead of
    being silently truncated by a blind uint32 cast.  Host-side (NumPy).
    """
    if isinstance(keys, torch.Tensor):
        if keys.dtype in (torch.uint16, torch.uint32):
            keys = to_i64(keys)
        keys = keys.detach().cpu().numpy()
    arr = np.asarray(keys)
    if arr.dtype == np.uint32:
        return arr.ravel()
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"keys must be integers, got dtype {arr.dtype}")
    flat = arr.ravel()
    if flat.size:
        lo, hi = flat.min(), flat.max()
        if lo < 0:
            raise ValueError(f"keys must be non-negative, got {lo}")
        if hi > _KEY_MAX:
            raise ValueError(f"keys must fit in 32 bits, got {hi}")
    return flat.astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Static sketch geometry: d rows x w columns of `counter` cells.

    With packed=True the table is STORED as uint32 lanes holding
    `counter.cells_per_lane` cells each; width stays the LOGICAL cell
    count and the packed path is bit-identical to the unpacked one.
    """

    width: int
    depth: int = 2
    counter: CounterSpec = CounterSpec()
    seed: int = 0x5EED
    packed: bool = False

    def __post_init__(self):
        if self.packed and self.width % self.counter.cells_per_lane:
            raise ValueError(
                f"packed width {self.width} must be a multiple of "
                f"cells_per_lane {self.counter.cells_per_lane}")

    @property
    def cells_per_lane(self) -> int:
        """Cells per uint32 storage lane (1 unless packed)."""
        return self.counter.cells_per_lane if self.packed else 1

    @property
    def storage_width(self) -> int:
        """Last-axis length of the stored table (lanes, not cells)."""
        return self.width // self.cells_per_lane

    @property
    def storage_dtype(self) -> torch.dtype:
        return torch.uint32 if self.packed else self.counter.dtype

    @property
    def memory_bytes(self) -> int:
        return self.width * self.depth * (self.counter.bits // 8)

    @classmethod
    def from_memory(cls, budget_bytes: int, depth: int = 2,
                    counter: CounterSpec = CounterSpec(), seed: int = 0x5EED,
                    packed: bool = False) -> "SketchSpec":
        """Paper-style sizing: fixed byte budget, width derived from cell
        size, rounded down to the reference's 128-cell (or 128-lane when
        packed) alignment so both packages build the same geometry."""
        cpl = counter.cells_per_lane if packed else 1
        align = 128 * cpl
        width = max(1, budget_bytes // (depth * (counter.bits // 8)))
        if width >= align:
            width -= width % align
        elif packed:
            width = max(cpl, width - width % cpl)
        return cls(width=width, depth=depth, counter=counter, seed=seed,
                   packed=packed)


@dataclasses.dataclass
class Sketch:
    table: torch.Tensor  # (depth, storage_width) storage-layout states
    spec: SketchSpec

    @property
    def row_seeds(self) -> torch.Tensor:
        return make_row_seeds(self.spec.seed, self.spec.depth,
                              device=self.table.device)


def init(spec: SketchSpec, device=None) -> Sketch:
    """A zero sketch on `device`: CUDA unless the caller passes "cpu"
    (`core/device.resolve_device`)."""
    return Sketch(table=zeros((spec.depth, spec.storage_width),
                              spec.storage_dtype, resolve_device(device)),
                  spec=spec)


def logical_table(table: torch.Tensor, spec: SketchSpec) -> torch.Tensor:
    """Stored table -> (..., d, width) int64 cell states."""
    if not spec.packed:
        return to_i64(table)
    return unpack_table(table, spec.counter.bits)


def storage_table(table: torch.Tensor, spec: SketchSpec) -> torch.Tensor:
    """Logical int64 cell states -> the stored layout and dtype."""
    if not spec.packed:
        return from_i64(to_i64(table), spec.counter.dtype)
    return pack_table(table, spec.counter.bits)


# --------------------------------------------------------------------------
# QUERY (paper Alg. 2)
# --------------------------------------------------------------------------

def query_state(sketch: Sketch, keys: torch.Tensor) -> torch.Tensor:
    """min_k sk[k, h_k(e)] -- raw counter state per key, int64 (N,)."""
    cols = row_hashes(keys, sketch.row_seeds, sketch.spec.width)  # (d, N)
    rows = torch.arange(sketch.spec.depth, device=cols.device)[:, None]
    table = logical_table(sketch.table, sketch.spec)
    return table[rows, cols].min(dim=0).values


def query(sketch: Sketch, keys: torch.Tensor, eager: bool = True
          ) -> torch.Tensor:
    """Estimated event counts (paper's VALUE of the min state), float32.
    Decoded as the reference's `sk.query` rounds when called op by op
    (its callers: `admit`, `topk.refresh`, the estimators, the admission
    "xla" engine), or with `eager=False` as under `jax.jit`."""
    counter = sketch.spec.counter
    state = query_state(sketch, keys)
    return counter.decode_eager(state) if eager else counter.decode(state)


def query_stacked(tables: torch.Tensor, spec: SketchSpec, keys: torch.Tensor
                  ) -> torch.Tensor:
    """Multi-table query: tables (T, d, w), keys (T, N) -> (T, N)."""
    return torch.stack([query(Sketch(table=t, spec=spec), k)
                        for t, k in zip(tables, keys)])


# --------------------------------------------------------------------------
# batched-update input: sort + segment-sum dedup
# --------------------------------------------------------------------------

def _dedup(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort + segment-count. Returns (sorted_keys, n_at_first_occurrence)."""
    return dedup_weighted(keys, torch.ones(keys.shape, dtype=torch.float32,
                                           device=keys.device))


def dedup_weighted(keys: torch.Tensor, weights: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted dedup along the last axis: sort keys, sum each key's
    weights at its first slot.

    keys (..., N) hold uint32 values; returns (sorted int64 keys, float32
    total weight at each key's first occurrence, 0 elsewhere), so
    duplicates and zero-weight entries are no-ops downstream.  Stable
    sort plus a segment sum: the totals are sums of float32 weights, as
    in the reference's `segment_sum`.
    """
    k = as_i64(keys)
    sorted_keys, order = torch.sort(k, dim=-1, stable=True)
    w_sorted = torch.gather(weights.to(torch.float32), -1, order)
    start = torch.ones_like(sorted_keys, dtype=torch.bool)
    start[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    seg = torch.cumsum(start.to(torch.int64), dim=-1) - 1
    totals = torch.zeros_like(w_sorted).scatter_add_(-1, seg, w_sorted)
    mult = torch.where(start, torch.gather(totals, -1, seg),
                       torch.zeros_like(w_sorted))
    return sorted_keys, mult


# --------------------------------------------------------------------------
# UPDATE -- one-shot batched conservative update
# --------------------------------------------------------------------------

def conservative_update_(cells: torch.Tensor, keys: torch.Tensor,
                         mult: torch.Tensor, uniforms: torch.Tensor,
                         row_seeds: torch.Tensor, counter: CounterSpec,
                         eager: bool = False) -> None:
    """One batch of the conservative update on R logical tables at once.

    cells (R, d, w) int64, updated in place; keys/mult/uniforms (R, n).
    Every key reads the minima from before the batch; writes land by
    scatter-max (mult == 0 writes state 0, a no-op under max).  `nfold`
    in the jitted graph (the kernels' and the XLA engines'), or eager.
    """
    r, d, w = cells.shape
    cols = row_hashes(keys, row_seeds, w)                     # (d, R, n)
    ri = torch.arange(r, device=cells.device).reshape(1, -1, 1)
    di = torch.arange(d, device=cells.device).reshape(-1, 1, 1)
    cmin = cells[ri, di, cols].min(dim=0).values              # (R, n)
    new = counter.nfold(cmin, mult, uniforms, eager=eager)
    write = torch.where(mult > 0, new, torch.zeros_like(new))
    flat_idx = (di * w + cols).permute(1, 0, 2).reshape(r, -1)
    src = write.unsqueeze(1).expand(r, d, -1).reshape(r, -1)
    cells.view(r, d * w).scatter_reduce_(1, flat_idx, src, reduce="amax")


def update_batched(sketch: Sketch, keys: torch.Tensor, rng,
                   weights: torch.Tensor | None = None,
                   damp_alpha: float = 0.0, eager: bool = True) -> Sketch:
    """Batch conservative update (sort -> dedup -> n-fold -> scatter-max)
    in ONE step: keys (N,) raw events, `rng` a raw threefry key whose
    uniforms (`prng.uniform(rng, (N,))`) drive the stochastic rounding.

    weights: optional per-event weights (default 1); equal keys sum
    before the n-fold step.  Returns a new Sketch.

    damp_alpha > 0 (depth >= 2; depth 1 is not damped, as in the
    reference) scales each key's added mass by
    ((V(min) + 1) / (V(2nd min) + 1)) ** damp_alpha over its d cells:
    the paper's §4 "probabilistic update rule" prototype, biased by
    construction.

    `eager`: the float graph of the reference's call, op by op (as its
    window updates, `ops.update`'s fallback and direct callers run it)
    or under `jax.jit` (`eager=False`: `launch/train --sketch`, the
    sharded updates).
    """
    spec = sketch.spec
    dev = sketch.table.device
    keys = keys.reshape(-1)
    if weights is None:
        weights = torch.ones(keys.shape, dtype=torch.float32, device=dev)
    sk_keys, mult = dedup_weighted(keys.to(dev), weights.to(dev))
    cells = logical_table(sketch.table, spec)[None]
    if damp_alpha > 0.0 and spec.depth >= 2:
        mult = mult * _damping(cells[0], sk_keys, sketch.row_seeds,
                               spec.counter, damp_alpha, eager)
    u = prng.uniform(rng, (keys.shape[0],), device=dev)
    conservative_update_(cells, sk_keys[None], mult[None], u[None],
                         sketch.row_seeds, spec.counter, eager)
    return Sketch(table=storage_table(cells[0], spec), spec=spec)


def _damping(cells: torch.Tensor, keys: torch.Tensor, row_seeds,
             counter: CounterSpec, alpha: float, eager: bool) -> torch.Tensor:
    """((decode(s0) + 1) / (decode(s1) + 1)) ** alpha per key, s0 <= s1
    the two smallest of its d cells.  `** alpha` is XLA's float32 power
    op by op, the C library's `powf` (`xla_f32.pow_host`, a round trip
    through the host: the damped update is a prototype, and the reference
    runs it only eagerly)."""
    cols = row_hashes(keys, row_seeds, cells.shape[-1])          # (d, N)
    rows = torch.arange(cells.shape[0], device=cells.device)[:, None]
    srt = torch.sort(cells[rows, cols], dim=0).values
    one = f32_const(1.0, cells.device)
    decode = counter.decode_eager if eager else counter.decode
    ratio = (decode(srt[0]) + one) / (decode(srt[1]) + one)
    return xla_f32.pow_host(ratio, alpha)


def update_exact(sketch: Sketch, keys, rng) -> Sketch:
    """Process events one at a time with conservative update (paper Alg. 1).

    keys (N,) event tensor; `rng` a raw threefry key whose uniforms
    (`prng.uniform(rng, (N,))`) drive IncreaseDecision.  A cell moves
    only if it sits at the key's minimum, the decision fired
    (u < increase_prob(min)) and the minimum is not saturated.  A plain
    loop of torch ops on the sketch's device, about 15 launches an event
    on CUDA (no kernel: the reference has none either).  Returns a new
    Sketch.
    """
    spec = sketch.spec
    counter = spec.counter
    dev = sketch.table.device
    keys = keys.reshape(-1).to(dev)
    n = keys.shape[0]
    cols = row_hashes(keys, sketch.row_seeds, spec.width)       # (d, N)
    u = prng.uniform(rng, (n,), device=dev)
    rows = torch.arange(spec.depth, device=dev)
    table = logical_table(sketch.table, spec).clone()
    for i in range(n):
        c = cols[:, i]
        cur = table[rows, c]
        cmin = cur.min()
        bump = ((u[i] < counter.increase_prob(cmin)) & (cur == cmin)
                & (cmin != counter.max_state))
        table[rows, c] = cur + bump.to(torch.int64)
    return Sketch(table=storage_table(table, spec), spec=spec)


def update(sketch: Sketch, keys, rng, mode: str = "batched") -> Sketch:
    """`update_exact` (mode="exact") or `update_batched` ("batched")."""
    if mode == "exact":
        return update_exact(sketch, keys, rng)
    if mode == "batched":
        return update_batched(sketch, keys, rng)
    raise ValueError(f"unknown update mode {mode!r}")


# --------------------------------------------------------------------------
# MERGE -- mergeable-summary semantics for distribution
# --------------------------------------------------------------------------

def merge(a: Sketch, b: Sketch, mode: str = "max", rng=None) -> Sketch:
    """Combine two sketches built with identical specs.

      max          -- elementwise max of states: the mergeable lower
                      bound for conservative-update sketches.
      estimate_sum -- decode both cells, add, re-encode
                      (`CounterSpec.reencode_stochastic`: stochastic
                      round with a raw key `rng`, floor without); the
                      right choice for shards that saw disjoint events.

    Both work on the logical tables and repack: a max over packed uint32
    lanes is not the per-cell max.
    """
    if a.spec != b.spec:
        raise ValueError("cannot merge sketches with different specs")
    c = a.spec.counter
    ta = logical_table(a.table, a.spec)
    tb = logical_table(b.table, b.spec)
    if mode == "max":
        table = torch.maximum(ta, tb)
    elif mode == "estimate_sum":
        v = c.decode_eager(ta) + c.decode_eager(tb)
        table = c.cells(c.reencode_stochastic(v, rng))
    else:
        raise ValueError(f"unknown merge mode {mode!r}")
    return Sketch(table=storage_table(table, a.spec), spec=a.spec)
