"""Public sketch ops over the hand-written kernels.

Counterpart of `repro/kernels/ops.py`: reads (`query`, `query_many`,
`window_query_tables`, `window_query_stacked`), updates (`update`,
`update_xla`, the untracked flush's `update_many` / `update_rows`, and
the tracked flush epoch `update_score_rows`: weighted dedup, parity
uniforms drawn in the kernel, fused update + candidate score), the
window leaf's rotation (`window_advance_rows`), the device-resident
ingest ring (`ring_width`, `queue_init`, `queue_append`, `flush_inputs`,
`flush_rows_inputs`), and the cold tier's device side (`tier_spill`,
`tier_query`, `tier_demote`, `tier_promote`).

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
from repro_torch.core import staging
from repro_torch.core.counters import from_i64, from_numpy, signed_view, zeros
from repro_torch.core.hashing import as_i64, host_row_seeds
from repro_torch.kernels import ref
from repro_torch.kernels import sketch as ksk
from repro_torch.kernels.sketch import CHUNK

LANES = 128
WINDOW_MODES = ("sum", "max")

# Table size at which the reference changes ALGORITHM, not a memory
# budget (its `VMEM_TABLE_LIMIT`): past it, `update`, `update_many` and
# `update_rows` switch to the one-shot `sk.update_batched`, the latter two
# with one `prng.split` key per row.  The port keeps the switch on every
# device, for parity.  The tracked flush and the reads keep their
# semantics past it (the chunked engine, and queries that equal the
# kernel's), so the kernels serve those at every table size.
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

def read_keys(keys, device) -> torch.Tensor:
    """Probe keys as torch.uint32 storage on `device`, for the reads: host
    arrays go up through `core/staging.py` (a pinned slot, one
    `non_blocking` copy), so a read issues no synchronize; tensors as
    `as_device_keys` takes them."""
    if isinstance(keys, torch.Tensor):
        return as_device_keys(keys, device)
    host = np.ascontiguousarray(keys, np.uint32).view(np.int32)
    return staging.upload(device, host)[0].view(torch.uint32)


def _query_tables(tables, spec, keys, engine):
    keys = read_keys(keys, tables.device)
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
    keys = read_keys(keys, sketch.table.device).reshape(1, -1)
    return _query_tables(sketch.table[None], sketch.spec, keys, engine)[0]


def query_many(tables: torch.Tensor, spec: sk.SketchSpec, keys,
               engine: str = "auto") -> torch.Tensor:
    """Fused multi-tenant query: tables (T, d, sw), keys (T, N) or (N,)
    (broadcast to every tenant).  Returns float32 (T, N)."""
    _check_engine(engine)
    keys = read_keys(keys, tables.device)
    if keys.dim() == 1:
        keys = keys.view(torch.int32).expand(tables.shape[0], -1)
        keys = keys.contiguous().view(torch.uint32)
    if keys.shape[0] != tables.shape[0]:
        raise ValueError(f"per-tenant keys need {tables.shape[0]} rows, "
                         f"got {keys.shape[0]}")
    _launch("query_many")
    return _query_tables(tables, spec, keys, engine)


def window_query_tables(tables: torch.Tensor, spec: sk.SketchSpec, keys,
                        weights: torch.Tensor, mode: str = "sum",
                        engine: str = "auto") -> torch.Tensor:
    """Weighted window reduction over one bucket ring: ONE launch.

    tables (B, d, sw), keys (N,), weights (B,) per-bucket estimate
    weights (0 = expired, gamma^age = lazy decay); mode "sum" (in bucket
    order) or "max".  Returns float32 (N,)."""
    _check_window(mode, engine)
    if tuple(weights.shape) != (tables.shape[0],):
        raise ValueError(f"need one weight per bucket: weights "
                         f"{tuple(weights.shape)} vs {tables.shape[0]} "
                         "buckets")
    _launch("window_query")
    dev = tables.device
    keys = read_keys(keys, dev).reshape(-1)
    weights = weights.to(device=dev, dtype=torch.float32).contiguous()
    if engine == "plain":
        return ref.window_query_plain(tables, keys, weights,
                                      _seed_tensor(spec, dev), spec.width,
                                      spec.counter, mode,
                                      spec.cells_per_lane)
    return ksk.window_query(tables, keys, weights, seeds=_seeds_tuple(spec),
                            width=spec.width, counter=spec.counter,
                            mode=mode, cpl=spec.cells_per_lane)


def window_query_stacked(tables: torch.Tensor, spec: sk.SketchSpec, keys,
                         weights: torch.Tensor, mode: str = "sum",
                         engine: str = "auto", rows=None) -> torch.Tensor:
    """Stacked multi-ring window reduction: R rings, ONE launch.

    tables (R, B, d, sw) rings, or with `rows` (R,) host ints the native
    (T, B, d, sw) window leaf read in place at those rings; keys (R, N),
    or without `rows` (N,) probes shared by every ring (the kernel reads
    them with ring stride 0: no (R, N) copy); weights (R, B).  Returns
    float32 (R, N), row r equal to a one-ring `window_query_tables` of
    ring r."""
    _check_window(mode, engine)
    n_rings = tables.shape[0] if rows is None else len(rows)
    dev = tables.device
    keys = read_keys(keys, dev)
    if keys.dim() == 1 and rows is None:
        if engine == "plain":
            keys = keys.expand(n_rings, -1)
    elif keys.shape[0] != n_rings:
        raise ValueError(f"per-ring keys need {n_rings} rows, "
                         f"got {keys.shape[0]}")
    if tuple(weights.shape) != (n_rings, tables.shape[1]):
        raise ValueError(f"need (R, B) weights: {tuple(weights.shape)} vs "
                         f"{(n_rings, tables.shape[1])}")
    _launch("window_query_stacked")
    weights = weights.to(device=dev, dtype=torch.float32).contiguous()
    kw = dict(width=spec.width, counter=spec.counter, mode=mode,
              cpl=spec.cells_per_lane)
    if engine == "plain":
        rows_d = (torch.arange(n_rings, device=dev) if rows is None else
                  staging.upload(dev, np.asarray(rows, np.int64))[0])
        return ref.window_query_stacked_rows_plain(
            tables, keys, weights, rows_d, _seed_tensor(spec, dev), **kw)
    if rows is None:
        return ksk.window_query_stacked(tables, keys, weights,
                                        seeds=_seeds_tuple(spec), **kw)
    return ksk.window_query_stacked_rows(tables, keys, weights, rows,
                                         seeds=_seeds_tuple(spec), **kw)


def _check_window(mode: str, engine: str) -> None:
    if mode not in WINDOW_MODES:
        raise ValueError(f"unknown window query mode {mode!r}")
    _check_engine(engine)


# --------------------------------------------------------------------------
# updates: single sketch, and the untracked flush
# --------------------------------------------------------------------------

def _one_shot(spec: sk.SketchSpec) -> bool:
    return spec.memory_bytes > ONE_SHOT_UPDATE_TABLE_BYTES


def _weights(keys: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return torch.ones(keys.shape, dtype=torch.float32, device=keys.device)
    return weights.to(device=keys.device, dtype=torch.float32)


def _uniform_grid(tables: torch.Tensor, rows: np.ndarray, uniform_rows):
    """(total, urows) of the parity uniform draw: the dense grid over
    `tables` at `rows`, unless the caller decouples it."""
    if uniform_rows is None:
        return tables.shape[0], rows
    total, urows = uniform_rows
    return int(total), np.asarray(urows, np.int64).reshape(-1)


def update(sketch: sk.Sketch, keys, rng, engine: str = "auto") -> sk.Sketch:
    """Batched conservative update of one sketch: `update_chunked` within
    the one-shot limit, past it the reference's one-shot
    `update_batched`.  Returns a new Sketch; the input's table is left as
    it was."""
    if not _one_shot(sketch.spec):
        return update_chunked(sketch, keys, rng, engine)
    _check_engine(engine)
    _launch("update")
    keys = as_device_keys(keys, sketch.table.device).reshape(-1)
    return sk.update_batched(sketch, keys, rng)


def update_chunked(sketch: sk.Sketch, keys, rng, engine: str = "auto"
                   ) -> sk.Sketch:
    """Dedup, uniforms from the raw key `rng`, and the CHUNK-sequential
    update (the T = 1 dense kernel), at every table size: the algorithm
    `update_xla` computes.  Returns a new Sketch; the input's table is
    left as it was."""
    _check_engine(engine)
    _launch("update")
    keys = as_device_keys(keys, sketch.table.device).reshape(-1)
    tables = sketch.table.clone()[None]
    weights = _weights(keys, None)[None]
    _update_chunked(tables, sketch.spec, keys[None], weights, rng,
                    (1, np.zeros(1, np.int64)), engine)
    return sk.Sketch(table=tables[0], spec=sketch.spec)


def update_xla(sketch: sk.Sketch, keys, rng) -> sk.Sketch:
    """The reference's CHUNK-sequential plain engine of `update`, at every
    table size (no one-shot switch).  Returns a new Sketch."""
    _launch("update")
    spec = sketch.spec
    dev = sketch.table.device
    keys = as_device_keys(keys, dev).reshape(-1)
    sorted_keys, mult = sk._dedup(keys)
    uniforms = prng.uniform(rng, sorted_keys.shape, device=dev)
    table = ref.update_chunked_ref(sketch.table, sorted_keys, mult, uniforms,
                                   _seed_tensor(spec, dev), spec.counter,
                                   CHUNK, cpl=spec.cells_per_lane)
    return sk.Sketch(table=table, spec=spec)


def _update_chunked(tables, spec, keys, weights, rng, grid, engine,
                    rows=None):
    """Dedup + parity uniforms + the update kernel, in place: the dense
    kernel (batch row i -> table i), which draws its uniforms itself, or
    with `rows` the row-mapped one, which takes them drawn."""
    total, urows = grid
    dev = tables.device
    sorted_keys, mult = sk.dedup_weighted(keys, weights)
    kw = dict(counter=spec.counter, cpl=spec.cells_per_lane)
    if engine == "plain":
        uniforms = _parity_uniforms(rng, keys.shape[1], total, urows, dev)
        seed_t = _seed_tensor(spec, dev)
        if rows is None:
            return ref.fused_update_plain(tables, sorted_keys, mult,
                                          uniforms, seed_t, chunk=CHUNK, **kw)
        return ref.fused_update_rows_plain(
            tables, sorted_keys, mult, uniforms, staging.upload(dev, rows)[0],
            seed_t, chunk=CHUNK, **kw)
    keys_u = from_i64(sorted_keys, torch.uint32)
    kw.update(seeds=_seeds_tuple(spec), width=spec.width)
    if rows is None:
        return ksk.fused_update(tables, keys_u, mult, rng, grid=grid, **kw)
    uniforms = _parity_uniforms(rng, keys.shape[1], total, urows, dev)
    return ksk.fused_update_rows(tables, keys_u, mult, uniforms, rows, **kw)


def _update_one_shot(tables, spec, keys, weights, rng, rows, grid):
    """Past the one-shot limit: row i takes `update_batched` with key
    split(rng, total)[urows[i]], written back into table rows[i]."""
    total, urows = grid
    rngs = prng.split(rng, total)[urows]
    for i, r in enumerate(rows.tolist()):
        new = sk.update_batched(sk.Sketch(table=tables[r], spec=spec),
                                keys[i], rngs[i], weights=weights[i])
        signed_view(tables)[r] = signed_view(new.table)
    return tables


def update_many(tables: torch.Tensor, spec: sk.SketchSpec, keys, rng,
                weights: torch.Tensor | None = None, uniform_rows=None,
                engine: str = "auto") -> torch.Tensor:
    """Dense multi-tenant update, IN PLACE: tables (T, d, sw), keys /
    weights (T, N) raw events (weight 0 = no-op).  Dedups every row and
    lands all T in ONE launch of the dense kernel.

    uniform_rows: optional (total, urows) pair: draw the uniforms over a
    (total, N) grid at `urows`, so updating a gathered R-row stack lands
    what the dense total-row update would.  Past the one-shot limit,
    row i takes `update_batched` with split key i (or urows[i])."""
    _check_engine(engine)
    dev = tables.device
    keys = as_device_keys(keys, dev)
    weights = _weights(keys, weights)
    rows = np.arange(tables.shape[0], dtype=np.int64)
    grid = _uniform_grid(tables, rows, uniform_rows)
    _launch("update_many")
    if _one_shot(spec):
        return _update_one_shot(tables, spec, keys, weights, rng, rows, grid)
    return _update_chunked(tables, spec, keys, weights, rng, grid, engine)


def update_rows(tables: torch.Tensor, spec: sk.SketchSpec, keys, rng, rows,
                weights: torch.Tensor | None = None, uniform_rows=None,
                engine: str = "auto") -> torch.Tensor:
    """Active-row update, IN PLACE: batch i (keys/weights (R, N)) lands in
    table rows[i] (host ints, unique); the other tables are untouched.

    Uniforms are rows `rows` of the dense (T, N) draw, so the result
    equals `update_many` over the whole stack with the other rows'
    weights zeroed.  uniform_rows: optional (total, urows) decoupling the
    draw from the row map -- the window flush updates flat rows
    tenant * B + cursor of its (T*B, d, sw) leaf view while drawing over
    the (T, N) tenant grid at the tenant rows.  Past the one-shot limit,
    `update_batched` per row with split keys."""
    _check_engine(engine)
    rows = np.asarray(rows, np.int64).reshape(-1)
    grid = _uniform_grid(tables, rows, uniform_rows)
    dev = tables.device
    keys = as_device_keys(keys, dev)
    weights = _weights(keys, weights)
    _launch("update_rows")
    if _one_shot(spec):
        return _update_one_shot(tables, spec, keys, weights, rng, rows, grid)
    return _update_chunked(tables, spec, keys, weights, rng, grid, engine,
                           rows=rows)


def rotation_mask(cursors, steps, buckets: int) -> np.ndarray:
    """(T, B) host mask of the buckets a rotation of steps[t] clears in
    ring t: the steps[t] buckets after cursors[t], all when >= B."""
    cursors = np.asarray(cursors, np.int64).reshape(-1, 1)
    steps = np.asarray(steps, np.int64).reshape(-1, 1)
    off = (np.arange(buckets)[None, :] - cursors - 1) % buckets  # 0 = next
    return (off < steps) | (steps >= buckets)


def window_advance_rows(tables: torch.Tensor, cursors, steps
                        ) -> torch.Tensor:
    """Watermark rotation on the native (T, B, d, sw) window leaf, IN
    PLACE, ONE masked zeroing for every tenant: ring t clears the
    steps[t] buckets after cursors[t] (all of them when steps[t] >= B);
    steps[t] == 0 leaves it untouched.  The caller owns the host cursor
    mirror: cursor' = (cursor + steps) % B.  The cleared buckets' flat
    indices t * B + b reach the device without a synchronize."""
    _launch("window_advance_rows")
    t, b = tables.shape[:2]
    flat = np.flatnonzero(rotation_mask(cursors, steps, b))
    if flat.size:
        idx = staging.upload(tables.device, flat.astype(np.int64))[0]
        signed_view(tables).view(t * b, -1).index_fill_(0, idx, 0)
    return tables


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
                      uniform_rows=None, engine: str = "auto"):
    """Single-launch flush epoch, IN PLACE on `tables`.

    tables (T, d, sw); keys/weights (R, N) active-row microbatches; rows
    (R,) target rows (unique); cand (R, M) each row's candidate keys.
    Dedups each row's batch (weights summed per key), draws the parity
    uniforms (rows `rows` of the dense (T, N) draw, so the tables land
    exactly as a whole-plane flush would), lands the chunk-sequential
    conservative update and scores the candidates against the updated
    rows.  uniform_rows: optional (total, urows) drawing the uniforms
    over a (total, N) grid at `urows` instead.  With the kernel the draw
    is made inside it, for the live slots only; the plain engine draws
    the (R, N) uniforms with `prng.uniform_rows`.  Returns (tables,
    float32 (R, M)).
    """
    _check_engine(engine)
    rows = np.asarray(rows, np.int32).reshape(-1)
    grid = _uniform_grid(tables, rows, uniform_rows)
    dev = tables.device
    keys = as_device_keys(keys, dev)
    weights = _weights(keys, weights)
    _launch("update_score_rows")
    sorted_keys, mult = sk.dedup_weighted(keys, weights)
    cand = as_device_keys(cand, dev)
    if engine == "plain":
        uniforms = _parity_uniforms(rng, keys.shape[1], *grid, dev)
        return ref.update_score_rows_ref(
            tables, sorted_keys, mult, uniforms, staging.upload(dev, rows)[0],
            cand, _seed_tensor(spec, dev), spec.counter, CHUNK,
            cpl=spec.cells_per_lane)
    return ksk.fused_update_score(
        tables, from_i64(sorted_keys, torch.uint32), mult, rng, cand, rows,
        grid=grid, seeds=_seeds_tuple(spec), width=spec.width,
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


def _live_mask(fill_d: torch.Tensor, cols: int) -> torch.Tensor:
    return (torch.arange(cols, device=fill_d.device)[None, :]
            < fill_d[:, None]).to(torch.float32)


def live_mask(fill, cols: int, device) -> torch.Tensor:
    """(R, cols) float32 live-slot mask of the host fills (R,), built on
    `device` from one staged upload of the fills (no synchronize): a
    tiered plane's cold rows, whose keys come from the host mirror."""
    fill_d = staging.upload(device, np.asarray(fill, np.int64))[0]
    return _live_mask(fill_d, cols)


def flush_inputs(queue: torch.Tensor, fill, cols: int):
    """(queue[:, :cols], (T, cols) float32 live-slot mask); only the (T,)
    fill vector crosses to the device, without a synchronize."""
    fill_d = staging.upload(queue.device, np.asarray(fill, np.int64))[0]
    return queue[:, :cols], _live_mask(fill_d, cols)


def flush_rows_inputs(queue: torch.Tensor, fill, rows, cols: int):
    """Active-row flush inputs: (queue[rows, :cols], (R, cols) mask); the
    rows and their fills cross to the device in one upload, without a
    synchronize."""
    rows_d, fill_d = staging.upload(queue.device,
                                    np.asarray(rows, np.int64),
                                    np.asarray(fill, np.int64))
    keys = signed_view(queue)[rows_d, :cols].view(torch.uint32)
    return keys, _live_mask(fill_d, cols)


# --------------------------------------------------------------------------
# tiered hot/cold plane storage (stream/tiering.py)
#
# The cold tier lives in host memory (numpy, storage layout); these are
# its device side.  A spill and a cold read run the same kernels as the
# hot tier, on a stack the caller uploaded, and each op tallies under its
# OWN name, so "a hot-tier flush epoch is one update_score_rows" stays a
# counted claim when cold tenants spill in the same epoch.
# --------------------------------------------------------------------------

def tier_spill(tables: torch.Tensor, spec: sk.SketchSpec, keys, rng,
               weights, uniform_rows, cand=None, engine: str = "auto"):
    """Cold-tier spill, IN PLACE on `tables`: C cold tenants' buffered
    batches land on their uploaded (C, d, sw) table stack.

    keys/weights (C, N) are the tenants' host queue-mirror slices; the
    dedup and the chunk order are the hot path's, and the uniforms are
    rows `urows` of the (total, N) grid (`uniform_rows` = (total, urows),
    REQUIRED: each stack row's tenant index in the full tenant grid), so
    a spilled row's cells equal what the hot flush would have landed had
    the tenant been resident.  Always the CHUNK-sequential engine (no
    one-shot switch, as in the reference).  With `cand` (C, M) the spill
    also scores the candidates against the updated rows and returns
    (tables, float32 (C, M)); without it, tables.  On the card: kernel 2
    with the identity row map (with `cand`) or kernel 5, each drawing its
    uniforms at `urows`; on the CPU or with engine "plain", their plain
    versions.  Tallied as "tier_spill" only."""
    _check_engine(engine)
    total, urows = uniform_rows
    total = int(total)
    urows = np.asarray(urows, np.int64).reshape(-1)
    dev = tables.device
    keys = as_device_keys(keys, dev)
    weights = _weights(keys, weights)
    _launch("tier_spill")
    sorted_keys, mult = sk.dedup_weighted(keys, weights)
    kw = dict(counter=spec.counter, cpl=spec.cells_per_lane)
    if engine == "plain":
        uniforms = _parity_uniforms(rng, keys.shape[1], total, urows, dev)
        seed_t = _seed_tensor(spec, dev)
        if cand is None:
            return ref.fused_update_plain(tables, sorted_keys, mult,
                                          uniforms, seed_t, chunk=CHUNK, **kw)
        rows_d = torch.arange(tables.shape[0], device=dev)
        return ref.update_score_rows_ref(
            tables, sorted_keys, mult, uniforms, rows_d,
            as_device_keys(cand, dev), seed_t, spec.counter, CHUNK,
            cpl=spec.cells_per_lane)
    keys_u = from_i64(sorted_keys, torch.uint32)
    kw.update(seeds=_seeds_tuple(spec), width=spec.width)
    if cand is None:
        return ksk.fused_update(tables, keys_u, mult, rng,
                                grid=(total, urows), **kw)
    return ksk.fused_update_score(
        tables, keys_u, mult, rng, as_device_keys(cand, dev),
        np.arange(tables.shape[0], dtype=np.int64), grid=(total, urows),
        **kw)


def tier_query(tables: torch.Tensor, spec: sk.SketchSpec, keys,
               engine: str = "auto") -> torch.Tensor:
    """Cold-tier read: float32 (C, N) estimates over an uploaded
    (C, d, sw) stack, through the same fused query as the hot tier
    (kernel 1 on the card), so hot and cold tenants answer a `query_all`
    identically.  keys (C, N), or (N,) broadcast to every row.  Tallied
    as "tier_query"."""
    _check_engine(engine)
    keys = read_keys(keys, tables.device)
    if keys.dim() == 1:
        keys = keys.view(torch.int32).expand(tables.shape[0], -1)
        keys = keys.contiguous().view(torch.uint32)
    if keys.shape[0] != tables.shape[0]:
        raise ValueError(f"per-tenant keys need {tables.shape[0]} rows, "
                         f"got {keys.shape[0]}")
    _launch("tier_query")
    return _query_tables(tables, spec, keys, engine)


def tier_demote(tables: torch.Tensor, rows) -> torch.Tensor:
    """Demotion gather: the demoted slots' tables out of the hot stack,
    ONE gather on the device (the caller copies them to the cold store;
    the ring needs no read-back, the host mirror holds its contents).
    Tallied as "tier_demote"."""
    _launch("tier_demote")
    idx = staging.upload(tables.device, np.asarray(rows, np.int64))[0]
    return signed_view(tables)[idx].view(tables.dtype)


def tier_promote(tables: torch.Tensor, queue: torch.Tensor, rows,
                 new_tables: torch.Tensor, new_queue: torch.Tensor):
    """Promotion scatter, IN PLACE: the promoted tenants' tables and
    ring-mirror rows land at hot slots `rows` of the table stack and the
    ring, one `index_copy_` each.  new_tables / new_queue are on the
    stacks' device (the caller's upload).  Tallied as "tier_promote";
    returns (tables, queue)."""
    _launch("tier_promote")
    idx = staging.upload(tables.device, np.asarray(rows, np.int64))[0]
    signed_view(tables).index_copy_(0, idx, signed_view(new_tables))
    signed_view(queue).index_copy_(0, idx, signed_view(new_queue))
    return tables, queue
