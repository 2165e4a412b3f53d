"""Public sketch ops over the hand-written kernels (main-path half).

Counterpart of `repro/kernels/ops.py` for the tracked counting service:
reads (`query`, `query_many`), the single-launch flush epoch
(`update_score_rows`: weighted dedup, parity uniforms, fused update +
candidate score), and the device-resident ingest ring (`ring_width`,
`queue_init`, `queue_append`, `flush_inputs`, `flush_rows_inputs`).

engine: "auto" hands the tensors to the kernel wrappers in
`kernels.sketch`, which launch the CUDA kernel for CUDA tensors and run
the plain version for CPU tensors.  "plain" runs the plain PyTorch
version (`kernels/ref.py`) on whatever device the tensors are on; it
exists for the tests and for `chip_smoke.py`'s kernel-vs-plain
comparison.

Every op tallies one dispatch under the reference's op name into the
active `audit_scope()` tallies (and the default `launch_counts()` scope),
so the structural claims ("a tracked flush epoch is one
update_score_rows per fill class") are checked against the same names in
both packages.  These are op dispatches, not kernel launches; the kernel
wrappers keep their own launch counts.
"""
from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import sketch as sk
from repro_torch.core.counters import from_i64, from_numpy, signed_view, zeros
from repro_torch.core.hashing import as_i64, host_row_seeds
from repro_torch.kernels import ref
from repro_torch.kernels import sketch as ksk
from repro_torch.kernels.sketch import CHUNK

LANES = 128

# Table size at which the reference changes ALGORITHM, not a memory
# budget: past it, its untracked flush (`update_many` / `update_rows`)
# switches to the one-shot `update_batched` with split rng keys.  The
# tracked flush and the reads keep their semantics past it (the chunked
# engine and `sk.query`), so in this slice the kernels serve every table
# size; the untracked flush will need the switch.
ONE_SHOT_UPDATE_TABLE_BYTES = 12 * 1024 * 1024

ENGINES = ("auto", "plain")

_DEFAULT_SCOPE: collections.Counter = collections.Counter()
_SCOPES: list[collections.Counter] = [_DEFAULT_SCOPE]


def _launch(name: str) -> None:
    for scope in _SCOPES:
        scope[name] += 1


class audit_scope:
    """Context manager scoping a dispatch tally to one with-block.

        with ops.audit_scope() as tally:
            svc.flush()
        assert dict(tally) == {"update_score_rows": 1}
    """

    def __init__(self):
        self.tally = collections.Counter()

    def __enter__(self) -> collections.Counter:
        _SCOPES.append(self.tally)
        return self.tally

    def __exit__(self, *exc) -> None:
        # remove by identity: Counters compare by value
        for i in range(len(_SCOPES) - 1, -1, -1):
            if _SCOPES[i] is self.tally:
                del _SCOPES[i]
                break


def launch_counts() -> dict[str, int]:
    """Snapshot of the default scope's {op: dispatches} since its reset."""
    return dict(_DEFAULT_SCOPE)


def reset_launch_counts() -> None:
    _DEFAULT_SCOPE.clear()


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; have {ENGINES}")


@functools.lru_cache(maxsize=None)
def _seeds_tuple(spec: sk.SketchSpec) -> tuple:
    return host_row_seeds(spec.seed, spec.depth)


def _seed_tensor(spec: sk.SketchSpec, device) -> torch.Tensor:
    return torch.tensor(_seeds_tuple(spec), dtype=torch.int64, device=device)


def as_device_keys(keys, device) -> torch.Tensor:
    """Keys (numpy or tensor, any integer dtype holding uint32 values) ->
    torch.uint32 storage on `device`."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype == torch.uint32:
            return keys.view(torch.int32).to(device).view(torch.uint32)
        if keys.dtype == torch.int32:
            return keys.to(device).view(torch.uint32)
        return from_i64(as_i64(keys.to(device)), torch.uint32)
    return from_numpy(np.asarray(keys, np.uint32), device)


# --------------------------------------------------------------------------
# reads
# --------------------------------------------------------------------------

def _query_tables(tables, spec, keys, engine):
    keys = as_device_keys(keys, tables.device)
    if engine == "plain":
        return ref.fused_query_plain(tables, keys,
                                     _seed_tensor(spec, tables.device),
                                     spec.width, spec.counter,
                                     spec.cells_per_lane)
    return ksk.fused_query(tables, keys, seeds=_seeds_tuple(spec),
                           width=spec.width, counter=spec.counter,
                           cpl=spec.cells_per_lane)


def query(sketch: sk.Sketch, keys, engine: str = "auto") -> torch.Tensor:
    """One sketch's estimates: float32 (N,) (the T = 1 fused query)."""
    _check_engine(engine)
    _launch("query")
    keys = as_device_keys(keys, sketch.table.device).reshape(1, -1)
    return _query_tables(sketch.table[None], sketch.spec, keys, engine)[0]


def query_many(tables: torch.Tensor, spec: sk.SketchSpec, keys,
               engine: str = "auto") -> torch.Tensor:
    """Fused multi-tenant query: tables (T, d, sw), keys (T, N) or (N,)
    (broadcast to every tenant).  Returns float32 (T, N)."""
    _check_engine(engine)
    keys = as_device_keys(keys, tables.device)
    if keys.dim() == 1:
        keys = keys.view(torch.int32).expand(tables.shape[0], -1)
        keys = keys.contiguous().view(torch.uint32)
    if keys.shape[0] != tables.shape[0]:
        raise ValueError(f"per-tenant keys need {tables.shape[0]} rows, "
                         f"got {keys.shape[0]}")
    _launch("query_many")
    return _query_tables(tables, spec, keys, engine)


# --------------------------------------------------------------------------
# single-launch flush epoch: fused update + candidate re-score
# --------------------------------------------------------------------------

def _parity_uniforms(rng, n_cols: int, total: int, rows, device
                     ) -> torch.Tensor:
    """Uniforms for an R-row update, bit-identical to the reference's
    full (total, n_cols) draw gathered at `rows` -- drawn directly for
    just those rows."""
    return prng.uniform_rows(rng, total, n_cols, rows, device=device)


def update_score_rows(tables: torch.Tensor, spec: sk.SketchSpec, keys, rng,
                      rows, cand, weights: torch.Tensor | None = None,
                      engine: str = "auto"):
    """Single-launch flush epoch, IN PLACE on `tables`.

    tables (T, d, sw); keys/weights (R, N) active-row microbatches; rows
    (R,) target rows (unique); cand (R, M) each row's candidate keys.
    Dedups each row's batch (weights summed per key), draws the parity
    uniforms (rows `rows` of the dense (T, N) draw, so the tables land
    exactly as a whole-plane flush would), lands the chunk-sequential
    conservative update and scores the candidates against the updated
    rows.  Returns (tables, float32 (R, M)).
    """
    _check_engine(engine)
    rows = np.asarray(rows, np.int32).reshape(-1)
    dev = tables.device
    keys = as_device_keys(keys, dev)
    if weights is None:
        weights = torch.ones(keys.shape, dtype=torch.float32, device=dev)
    _launch("update_score_rows")
    sorted_keys, mult = sk.dedup_weighted(keys, weights)
    uniforms = _parity_uniforms(rng, keys.shape[1], tables.shape[0], rows,
                                dev)
    cand = as_device_keys(cand, dev)
    rows_d = torch.from_numpy(rows).to(dev)
    if engine == "plain":
        return ref.update_score_rows_ref(
            tables, sorted_keys, mult, uniforms, rows_d, cand,
            _seed_tensor(spec, dev), spec.counter, CHUNK,
            cpl=spec.cells_per_lane)
    return ksk.fused_update_score(
        tables, from_i64(sorted_keys, torch.uint32), mult, uniforms, cand,
        rows_d, seeds=_seeds_tuple(spec), width=spec.width,
        counter=spec.counter, cpl=spec.cells_per_lane)


# --------------------------------------------------------------------------
# device-resident ingest queue
# --------------------------------------------------------------------------

def ring_width(capacity: int) -> int:
    """Lane-aligned device ring width for a logical queue capacity."""
    return max(LANES, LANES * -(-int(capacity) // LANES))


def queue_init(tenants: int, capacity: int, device) -> torch.Tensor:
    """Fresh (T, capw) device ring (uint32 keys, lane-aligned width)."""
    return zeros((tenants, ring_width(capacity)), torch.uint32, device)


def queue_append(queue: torch.Tensor, keys, rows, fill, count,
                 engine: str = "auto") -> torch.Tensor:
    """Append R tenant microbatches to the device ring, IN PLACE.

    keys (R, N) ragged per `count`; rows/fill/count (R,) host integers.
    A whole-plane append (rows == 0..T-1) takes the dense kernel, any
    other the row-mapped one.  The caller tracks fill on the host.
    """
    _check_engine(engine)
    _launch("queue_append")
    rows = np.asarray(rows, np.int64).reshape(-1)
    fill = np.asarray(fill, np.int64).reshape(-1)
    count = np.asarray(count, np.int64).reshape(-1)
    keys = as_device_keys(keys, queue.device)
    dense = rows.shape[0] == queue.shape[0] and np.array_equal(
        rows, np.arange(queue.shape[0]))
    if engine == "plain":
        dev = queue.device
        fill_d = torch.from_numpy(fill).to(dev)
        count_d = torch.from_numpy(count).to(dev)
        if dense:
            return ref.queue_append_dense_plain(queue, keys, fill_d, count_d)
        return ref.queue_append_plain(queue, keys,
                                      torch.from_numpy(rows).to(dev),
                                      fill_d, count_d)
    if dense:
        return ksk.queue_append_dense(queue, keys, fill, count)
    return ksk.queue_append(queue, keys, rows, fill, count)


def _live_mask(fill, cols: int, device) -> torch.Tensor:
    fill_d = torch.from_numpy(np.asarray(fill, np.int64)).to(device)
    return (torch.arange(cols, device=device)[None, :]
            < fill_d[:, None]).to(torch.float32)


def flush_inputs(queue: torch.Tensor, fill, cols: int):
    """(queue[:, :cols], (T, cols) float32 live-slot mask); only the (T,)
    fill vector crosses to the device."""
    return queue[:, :cols], _live_mask(fill, cols, queue.device)


def flush_rows_inputs(queue: torch.Tensor, fill, rows, cols: int):
    """Active-row flush inputs: (queue[rows, :cols], (R, cols) mask)."""
    rows_d = torch.from_numpy(np.asarray(rows, np.int64)).to(queue.device)
    keys = signed_view(queue)[rows_d, :cols].view(torch.uint32)
    return keys, _live_mask(fill, cols, queue.device)
