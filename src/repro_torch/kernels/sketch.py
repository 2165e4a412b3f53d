"""Wrappers of the hand-written CUDA sketch kernels, one per kernel.

Each wrapper checks device, dtype, shape and contiguity, then:

  * for CPU tensors, runs the kernel's plain PyTorch version
    (`kernels/ref.py`);
  * for CUDA tensors, launches its kernel on the current stream (the
    library is built from `kernels/csrc/` at first use, see
    `kernels/build.py`) and raises if the launch reports a CUDA error.
    There is no fallback: a CUDA tensor is served by the kernel or the
    call raises.

Each wrapper carries a plain integer `launches` attribute, bumped once
where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels (`kernel_launches`,
`reset_kernel_launches`).  It counts wrapper calls: one call of
`fused_update_score` launches two CUDA kernels (the update, then the
candidate scores), and a call past a launch's row cap splits over more.

| wrapper                     | replaces (src/repro/kernels/sketch.py) |
|-----------------------------|-----------------------------------------|
| `fused_query`               | `fused_query_pallas` :298              |
| `fused_update_score`        | `fused_update_score_pallas` :422       |
| `fused_update_rows`         | `fused_update_rows_pallas` :344        |
| `fused_update`              | `fused_update_pallas` :259             |
| `window_query`              | `window_query_pallas` :618             |
| `window_query_stacked`      | `window_query_stacked_pallas` :686     |
| `window_query_stacked_rows` | `window_query_stacked_rows_pallas` :741|
| `queue_append`              | `queue_append_pallas` :526             |
| `queue_append_dense`        | `queue_append_dense_pallas` :587       |

Row maps of the four row-mapped wrappers (`fused_update_score`,
`fused_update_rows`, `window_query_stacked_rows`, and `fused_update`'s
identity map) are host integers, checked on the host (range, and
uniqueness where the kernel writes) and passed to the kernel by value in
its parameter block, as the ring appends' per-row meta (rows, fill,
count) are: these calls make no device tensor and no copy for their
meta.  `fused_update_score` and `fused_update` take the flush's raw
threefry key and the rows of its uniform grid the same way, and draw
their stochastic-rounding uniforms inside the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.counters import CounterSpec
from repro_torch.kernels import build, ref

CHUNK = 1024   # keys per sequential update step: part of the semantics
MAX_DEPTH = 8  # CML_MAX_DEPTH in csrc/common.cuh

_KEY_DTYPES = (torch.uint32, torch.int32)


def _seed_tensor(seeds: tuple, device) -> torch.Tensor:
    return torch.tensor(seeds, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _seed_array(seeds: tuple):
    """The row seeds as the uint32 array the C entry points read (kept:
    read-only, made once per spec)."""
    return (ctypes.c_uint32 * len(seeds))(*seeds)


def _stream(device) -> int:
    """The raw handle of torch's current stream on a tensor's device, read
    without building a torch.cuda.Stream object (the call torch's own
    generated kernels make): a few microseconds less on every launch."""
    index = device.index
    if index is None:  # a bare "cuda": the current device
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _device_kind(*tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


_GEOMETRY: dict = {}  # (shape, dtype, width, counter, cpl) -> words


def _table_geometry(tables: torch.Tensor, width: int, counter: CounterSpec,
                    cpl: int) -> int:
    """Validate a (T, d, sw) table stack; return 32-bit words per row.
    The shape checks are cached per geometry (a wrapper runs them on
    every launch)."""
    key = (tables.shape, tables.dtype, width, counter, cpl)
    wpr = _GEOMETRY.get(key)
    if wpr is None:
        wpr = _GEOMETRY[key] = _check_geometry(tables, width, counter, cpl,
                                               3)
    if not tables.is_contiguous():
        raise ValueError("tables must be contiguous")
    return wpr


def _check_geometry(tables, width, counter, cpl, dims) -> int:
    shape = tuple(tables.shape)
    _need(len(shape) == dims, f"tables must be (T, d, sw), got {shape}")
    want = torch.uint32 if cpl > 1 else counter.dtype
    _need(tables.dtype == want, f"tables dtype {tables.dtype}, expected "
                                f"{want}")
    _need(shape[-1] * cpl == width,
          f"table rows hold {shape[-1] * cpl} cells, width {width}")
    _need(1 <= shape[-2] <= MAX_DEPTH,
          f"depth {shape[-2]} outside [1, {MAX_DEPTH}]")
    bits = counter.bits
    _need(width * bits % 32 == 0,
          f"kernel rows are read as 32-bit words: width {width} x {bits} "
          "bits must be a multiple of 32")
    return width * bits // 32


@functools.lru_cache(maxsize=None)
def _counter_args(counter: CounterSpec):
    return (counter.bits, int(counter.kind == "log"), counter.max_state,
            counter.logb if counter.kind == "log" else 0.0,
            counter.bm1 if counter.kind == "log" else 0.0)


def _keys_ok(name: str, keys: torch.Tensor, shape=None) -> None:
    # messages are formatted only on failure: this runs on every launch
    if keys.dtype not in _KEY_DTYPES:
        raise ValueError(f"{name} must be uint32 or int32 on CUDA, got "
                         f"{keys.dtype}")
    if shape is not None and tuple(keys.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(keys.shape)}, expected "
                         f"{tuple(shape)}")
    if not keys.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# --------------------------------------------------------------------------
# fused query
# --------------------------------------------------------------------------

def fused_query(tables: torch.Tensor, keys: torch.Tensor, *, seeds: tuple,
                width: int, counter: CounterSpec, cpl: int = 1
                ) -> torch.Tensor:
    """Multi-tenant query: tables (T, d, sw), keys (T, N) -> float32 (T, N)."""
    kind = _device_kind(tables, keys)
    wpr = _table_geometry(tables, width, counter, cpl)
    t, d, _ = tables.shape
    _need(keys.dim() == 2 and keys.shape[0] == t,
          f"keys must be (T={t}, N), got {tuple(keys.shape)}")
    _need(len(seeds) == d, f"{len(seeds)} seeds for depth {d}")
    if kind == "cpu":
        return ref.fused_query_plain(tables, keys, _seed_tensor(seeds, "cpu"),
                                     width, counter, cpl)
    n = keys.shape[1]
    _keys_ok("keys", keys, (t, n))
    out = torch.empty((t, n), dtype=torch.float32, device=tables.device)
    rc = build.load().cml_fused_query(
        tables.data_ptr(), t, d, wpr, keys.data_ptr(), n, out.data_ptr(),
        _seed_array(seeds), width, *_counter_args(counter),
        _stream(tables.device))
    _check_cuda("fused_query", rc)
    fused_query.launches += 1
    return out


fused_query.launches = 0


# --------------------------------------------------------------------------
# updates (the flush epoch)
# --------------------------------------------------------------------------

MAX_MAPPED_ROWS = 1024  # CML_ROWMAP_MAX_ROWS in csrc/common.cuh


def _host_rows(rows, limit: int, unique: bool) -> np.ndarray:
    """A row map as a C-contiguous int64 host array, checked by one sort:
    every row in [0, limit) (the sorted ends) and, where the kernel
    writes, unique (no equal neighbours).  The C entry points pass it to
    the kernel by value, CML_ROWMAP_MAX_ROWS rows a launch."""
    rows = np.ascontiguousarray(rows, np.int64).reshape(-1)
    if rows.size:
        s = np.sort(rows)
        if s[0] < 0 or s[-1] >= limit:
            raise ValueError(f"rows outside [0, {limit})")
        if unique and np.count_nonzero(s[1:] == s[:-1]):
            raise ValueError("rows must be unique")
    return rows


def _update_batch(tables, keys, n_rows, seeds, **per_key):
    """Check an update's (R, N) keys and the float32 inputs `per_key`
    (mult, and uniforms where the caller passes them) of keys' shape."""
    # messages are formatted only on failure: this runs on every launch
    shape = keys.shape
    if len(shape) != 2 or shape[0] != n_rows:
        raise ValueError(f"keys must be (R={n_rows}, N), got {tuple(shape)}")
    if any(x.shape != shape for x in per_key.values()):
        raise ValueError(f"{' and '.join(per_key)} must match keys' (R, N)")
    if len(seeds) != tables.shape[1]:
        raise ValueError(f"{len(seeds)} seeds for depth {tables.shape[1]}")


def _update_cuda_ok(keys, **floats) -> None:
    # shapes were checked by _update_batch
    _keys_ok("keys", keys)
    for name, x in floats.items():
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")


def fused_update_rows(tables: torch.Tensor, keys: torch.Tensor,
                      mult: torch.Tensor, uniforms: torch.Tensor, rows, *,
                      seeds: tuple, width: int, counter: CounterSpec,
                      cpl: int = 1) -> torch.Tensor:
    """Row-mapped update, IN PLACE: batch row i lands in table rows[i]
    (host integers, unique), CHUNK-sequentially; the other tables are
    untouched.  tables (T, d, sw) -- for the window flush, the flat
    (T*B, d, sw) view of the window leaf; keys/mult/uniforms (R, N)."""
    kind = _device_kind(tables, keys, mult, uniforms)
    wpr = _table_geometry(tables, width, counter, cpl)
    rows = _host_rows(rows, tables.shape[0], unique=True)
    _update_batch(tables, keys, rows.shape[0], seeds, mult=mult,
                  uniforms=uniforms)
    d = tables.shape[1]
    if kind == "cpu":
        return ref.fused_update_rows_plain(
            tables, keys, mult, uniforms, torch.from_numpy(rows),
            _seed_tensor(seeds, "cpu"), counter, CHUNK, cpl)
    _update_cuda_ok(keys, mult=mult, uniforms=uniforms)
    rc = build.load().cml_fused_update_rows(
        tables.data_ptr(), d, wpr, rows.ctypes.data, rows.shape[0],
        keys.data_ptr(), mult.data_ptr(), uniforms.data_ptr(), keys.shape[1],
        _seed_array(seeds), width, *_counter_args(counter),
        _stream(tables.device))
    _check_cuda("fused_update_rows", rc)
    fused_update_rows.launches += 1
    return tables


fused_update_rows.launches = 0


def _flush_key(rng) -> tuple[int, int]:
    """The flush's raw threefry key as two uint32 integers."""
    k = np.asarray(rng, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def _draw_grid(grid, rows: np.ndarray, n_tables: int):
    """(total, urows) of a drawn update: batch row i takes row urows[i] of
    the flush's (total, N) uniform grid; by default the dense grid over
    the tables at `rows`.  urows as a C-contiguous int64 host array, one
    per row, in [0, total) (total < 2^31: the kernels carry int32 rows)."""
    if grid is None:
        return n_tables, rows
    total, urows = int(grid[0]), np.ascontiguousarray(grid[1], np.int64)
    urows = urows.reshape(-1)
    if urows.shape != rows.shape:
        raise ValueError(f"grid rows {urows.shape}, expected one per batch "
                         f"row {rows.shape}")
    if not 0 < total < 2**31:
        raise ValueError(f"grid total {total} outside [1, 2^31)")
    if urows.size and (urows.min() < 0 or urows.max() >= total):
        raise ValueError(f"grid rows must lie in [0, {total})")
    return total, urows


def fused_update_score(tables: torch.Tensor, keys: torch.Tensor,
                       mult: torch.Tensor, rng, cand: torch.Tensor, rows, *,
                       grid=None, seeds: tuple, width: int,
                       counter: CounterSpec, cpl: int = 1):
    """The tracked flush epoch, IN PLACE on `tables`.

    tables (T, d, sw); keys/mult (R, N) pre-deduplicated batches (mult ==
    0 entries are no-ops); rng the flush's raw threefry key; cand (R, M)
    candidate keys; rows (R,) host integers, the target tables, unique.
    Batch row i lands CHUNK-sequentially in table rows[i] with the
    uniforms of row urows[i] of the flush's (total, N) draw, `grid` =
    (total, urows), by default (T, rows); then its candidates are scored
    against the updated table.  On CUDA the kernel draws the uniforms
    itself (no uniform tensor is made); on the CPU they come from
    `prng.uniform_rows`.  Returns (tables, float32 (R, M) estimates).
    """
    kind = _device_kind(tables, keys, mult, cand)
    wpr = _table_geometry(tables, width, counter, cpl)
    rows = _host_rows(rows, tables.shape[0], unique=True)
    r = rows.shape[0]
    _update_batch(tables, keys, r, seeds, mult=mult)
    _need(cand.dim() == 2 and cand.shape[0] == r,
          f"cand must be (R={r}, M), got {tuple(cand.shape)}")
    total, urows = _draw_grid(grid, rows, tables.shape[0])
    key = _flush_key(rng)
    n = keys.shape[1]
    if kind == "cpu":
        uniforms = prng.uniform_rows(key, total, n, urows)
        return ref.update_score_rows_ref(
            tables, keys, mult, uniforms, torch.from_numpy(rows), cand,
            _seed_tensor(seeds, "cpu"), counter, CHUNK, cpl=cpl)
    m = cand.shape[1]
    _update_cuda_ok(keys, mult=mult)
    _keys_ok("cand", cand)
    est = torch.empty((r, m), dtype=torch.float32, device=tables.device)
    rc = build.load().cml_fused_update_score(
        tables.data_ptr(), tables.shape[1], wpr, rows.ctypes.data,
        urows.ctypes.data, r, keys.data_ptr(), mult.data_ptr(), n, *key,
        cand.data_ptr(), est.data_ptr(), m, _seed_array(seeds), width,
        *_counter_args(counter), _stream(tables.device))
    _check_cuda("fused_update_score", rc)
    fused_update_score.launches += 1
    return tables, est


fused_update_score.launches = 0


@functools.lru_cache(maxsize=None)
def _identity_rows(t: int) -> np.ndarray:
    rows = np.arange(t, dtype=np.int64)
    rows.flags.writeable = False
    return rows


def fused_update(tables: torch.Tensor, keys: torch.Tensor,
                 mult: torch.Tensor, rng, *, grid=None, seeds: tuple,
                 width: int, counter: CounterSpec, cpl: int = 1
                 ) -> torch.Tensor:
    """Dense multi-tenant update, IN PLACE: batch row i lands in table i,
    CHUNK-sequentially, with the uniforms of row urows[i] of the flush's
    (total, N) draw under the raw key `rng` (`grid` = (total, urows), by
    default (T, 0..T-1)).  tables (T, d, sw); keys/mult (T, N).  On CUDA
    the kernel draws the uniforms itself; on the CPU they come from
    `prng.uniform_rows`."""
    kind = _device_kind(tables, keys, mult)
    wpr = _table_geometry(tables, width, counter, cpl)
    t = tables.shape[0]
    _update_batch(tables, keys, t, seeds, mult=mult)
    rows = _identity_rows(t)
    total, urows = _draw_grid(grid, rows, t)
    key = _flush_key(rng)
    n = keys.shape[1]
    if kind == "cpu":
        uniforms = prng.uniform_rows(key, total, n, urows)
        return ref.fused_update_plain(tables, keys, mult, uniforms,
                                      _seed_tensor(seeds, "cpu"), counter,
                                      CHUNK, cpl)
    _update_cuda_ok(keys, mult=mult)
    rc = build.load().cml_fused_update(
        tables.data_ptr(), tables.shape[1], wpr, rows.ctypes.data,
        urows.ctypes.data, t, keys.data_ptr(), mult.data_ptr(), n, *key,
        _seed_array(seeds), width, *_counter_args(counter),
        _stream(tables.device))
    _check_cuda("fused_update", rc)
    fused_update.launches += 1
    return tables


fused_update.launches = 0


# --------------------------------------------------------------------------
# window queries
# --------------------------------------------------------------------------

_MODES = {"sum": 0, "max": 1}
_RINGS: dict = {}  # (shape, dtype, width, counter, cpl) -> words per row


def _ring_geometry(tables: torch.Tensor, width: int, counter: CounterSpec,
                   cpl: int, dims: int) -> int:
    """Validate one ring (B, d, sw) (dims 3) or a ring stack (R, B, d, sw)
    (dims 4); return 32-bit words per row.  The shape checks are cached
    per geometry."""
    key = (tables.shape, tables.dtype, width, counter, cpl)
    wpr = _RINGS.get(key)
    if wpr is None:
        what = "(B, d, sw)" if dims == 3 else "(R, B, d, sw)"
        _need(tables.dim() == dims,
              f"rings must be {what}, got {tuple(tables.shape)}")
        _need(tables.shape[-3] >= 1, "need at least one bucket")
        wpr = _RINGS[key] = _check_geometry(tables, width, counter, cpl,
                                            dims)
    if not tables.is_contiguous():
        raise ValueError("rings must be contiguous")
    return wpr


def _window_inputs(tables, keys, weights, n_rings: int, shared_ok: bool,
                   seeds: tuple, mode: str, one_ring: bool = False) -> int:
    """Check a window query's keys ((R, N), or (N,) where `shared_ok`),
    weights ((R, B), or (B,) for `one_ring`), seeds and mode; return the
    mode's kernel flag."""
    # messages are formatted only on failure: this runs on every launch
    mode_max = _MODES.get(mode)
    if mode_max is None:
        raise ValueError(f"unknown window query mode {mode!r}")
    b, d = tables.shape[-3], tables.shape[-2]
    if not ((shared_ok and keys.dim() == 1)
            or (keys.dim() == 2 and keys.shape[0] == n_rings)):
        raise ValueError(f"keys must be (R={n_rings}, N)"
                         + (" or (N,)" if shared_ok else "")
                         + f", got {tuple(keys.shape)}")
    want = (b,) if one_ring else (n_rings, b)
    if weights.shape != want:
        raise ValueError(f"weights must be {want}, got "
                         f"{tuple(weights.shape)}")
    if len(seeds) != d:
        raise ValueError(f"{len(seeds)} seeds for depth {d}")
    return mode_max


def _window_cuda_ok(weights) -> None:
    if weights.dtype != torch.float32 or not weights.is_contiguous():
        raise ValueError("weights must be contiguous float32")


def _window_lanes(wrapper, tables, keys, weights, n_rings, wpr, mode_max,
                  seeds, width, counter) -> torch.Tensor:
    """Launch kernel 7 or 8 (`wrapper`'s): R rings, keys (R, N), or (N,)
    read by every ring (ring stride 0), weights (R, B); float32 (R, N),
    or (N,) for one ring."""
    _keys_ok("keys", keys)
    n = keys.shape[-1]
    stride = 0 if keys.dim() == 1 else n
    _window_cuda_ok(weights)
    shape = (n,) if wrapper is window_query else (n_rings, n)
    out = torch.empty(shape, dtype=torch.float32, device=tables.device)
    rc = getattr(build.load(), "cml_" + wrapper.__name__)(
        tables.data_ptr(), n_rings, tables.shape[-3], tables.shape[-2], wpr,
        keys.data_ptr(), stride, n, weights.data_ptr(), out.data_ptr(),
        mode_max, _seed_array(seeds), width, *_counter_args(counter),
        _stream(tables.device))
    _check_cuda(wrapper.__name__, rc)
    wrapper.launches += 1
    return out


def window_query(tables: torch.Tensor, keys: torch.Tensor,
                 weights: torch.Tensor, *, seeds: tuple, width: int,
                 counter: CounterSpec, mode: str = "sum", cpl: int = 1
                 ) -> torch.Tensor:
    """One ring's window query: tables (B, d, sw), keys (N,), weights
    (B,) float32 -> float32 (N,): per key, the weighted "sum" (in bucket
    order) or "max" over buckets of the query estimate."""
    kind = _device_kind(tables, keys, weights)
    wpr = _ring_geometry(tables, width, counter, cpl, dims=3)
    if keys.dim() != 1:
        raise ValueError(f"keys must be (N,), got {tuple(keys.shape)}")
    mode_max = _window_inputs(tables, keys, weights, 1, True, seeds, mode,
                              one_ring=True)
    if kind == "cpu":
        return ref.window_query_plain(tables, keys, weights,
                                      _seed_tensor(seeds, "cpu"), width,
                                      counter, mode, cpl)
    return _window_lanes(window_query, tables, keys, weights, 1, wpr,
                         mode_max, seeds, width, counter)


window_query.launches = 0


def window_query_stacked(tables: torch.Tensor, keys: torch.Tensor,
                         weights: torch.Tensor, *, seeds: tuple, width: int,
                         counter: CounterSpec, mode: str = "sum",
                         cpl: int = 1) -> torch.Tensor:
    """R rings in one launch: tables (R, B, d, sw), keys (R, N) per ring
    or (N,) shared by every ring (read with ring stride 0, not copied),
    weights (R, B) -> float32 (R, N)."""
    kind = _device_kind(tables, keys, weights)
    wpr = _ring_geometry(tables, width, counter, cpl, dims=4)
    r = tables.shape[0]
    mode_max = _window_inputs(tables, keys, weights, r, True, seeds, mode)
    if kind == "cpu":
        if keys.dim() == 1:
            keys = keys.expand(r, -1)
        return ref.window_query_stacked_plain(
            tables, keys, weights, _seed_tensor(seeds, "cpu"), width,
            counter, mode, cpl)
    return _window_lanes(window_query_stacked, tables, keys, weights, r, wpr,
                         mode_max, seeds, width, counter)


window_query_stacked.launches = 0


def window_query_stacked_rows(tables: torch.Tensor, keys: torch.Tensor,
                              weights: torch.Tensor, rows, *, seeds: tuple,
                              width: int, counter: CounterSpec,
                              mode: str = "sum", cpl: int = 1
                              ) -> torch.Tensor:
    """Rings rows[i] (host integers) of the native (T, B, d, sw) window
    leaf, read in place: keys (R, N), weights (R, B) -> float32 (R, N)."""
    kind = _device_kind(tables, keys, weights)
    wpr = _ring_geometry(tables, width, counter, cpl, dims=4)
    rows = _host_rows(rows, tables.shape[0], unique=False)
    r = rows.shape[0]
    mode_max = _window_inputs(tables, keys, weights, r, False, seeds, mode)
    if kind == "cpu":
        return ref.window_query_stacked_rows_plain(
            tables, keys, weights, torch.from_numpy(rows),
            _seed_tensor(seeds, "cpu"), width, counter, mode, cpl)
    _keys_ok("keys", keys)
    _window_cuda_ok(weights)
    n = keys.shape[1]
    out = torch.empty((r, n), dtype=torch.float32, device=tables.device)
    _, b, d, _ = tables.shape
    rc = build.load().cml_window_query_stacked_rows(
        tables.data_ptr(), r, b, d, wpr, rows.ctypes.data, keys.data_ptr(),
        n, weights.data_ptr(), out.data_ptr(), mode_max, _seed_array(seeds),
        width, *_counter_args(counter), _stream(tables.device))
    _check_cuda("window_query_stacked_rows", rc)
    window_query_stacked_rows.launches += 1
    return out


window_query_stacked_rows.launches = 0


# --------------------------------------------------------------------------
# device-ring appends
# --------------------------------------------------------------------------

MAX_APPEND_ROWS = 1024  # CML_APPEND_MAX_ROWS in csrc/common.cuh
_APPEND_LIMITS: dict = {}  # (t, capw, n, k) -> `_append_limits`


def _append_limits(t: int, capw: int, n: int, k: int) -> np.ndarray:
    """Inclusive upper bounds of [rows,] fill, count, fill + count, as a
    (k + 1, 1) uint64 column (cached per shape)."""
    key = (t, capw, n, k)
    lim = _APPEND_LIMITS.get(key)
    if lim is None:
        lim = _APPEND_LIMITS[key] = np.array(
            ((t - 1,), (capw,), (n,), (capw,))[3 - k:], np.uint64)
    return lim


def _append_meta(queue: torch.Tensor, keys: torch.Tensor, rows, fill,
                 count) -> np.ndarray:
    """Check one ring append against the kernels' contract; return its
    (k, R) int64 host meta, C-contiguous: (rows, fill, count), or (fill,
    count) when `rows` is None (the dense append: batch row i -> ring row
    i).

    The checks run on one int64 array in one pass: its rows and fill +
    count, viewed as unsigned (a negative wraps past every bound), in one
    comparison with the bounds; rows are checked unique by a sort.
    Messages are built only for a call that fails."""
    if queue.dim() != 2 or queue.dtype != torch.uint32:
        raise ValueError("queue must be a (T, capw) uint32 ring")
    if not queue.is_contiguous():
        raise ValueError("queue must be contiguous")
    t, capw = queue.shape
    cols = (fill, count) if rows is None else (rows, fill, count)
    k = len(cols)
    try:
        meta = np.array(cols, np.int64)
        if meta.ndim != 2:
            meta = meta.reshape(k, -1)
    except ValueError:
        meta = None
    n_rows = t if rows is None else (
        np.size(rows) if meta is None else meta.shape[1])
    if keys.dim() != 2 or keys.shape[0] != n_rows:
        raise ValueError(f"keys must be (R={n_rows}, N), got "
                         f"{tuple(keys.shape)}")
    if meta is None or meta.shape[1] != n_rows:
        raise ValueError("fill and count need one entry per batch row")
    n = keys.shape[1]
    chk = np.empty((k + 1, n_rows), np.int64)
    chk[:k] = meta
    np.add(meta[-2], meta[-1], out=chk[k])
    if np.count_nonzero(chk.view(np.uint64) > _append_limits(t, capw, n, k)):
        _need(meta[-2:].min() >= 0, "fill and count must be non-negative")
        _need(meta[-1].max() <= n, "count exceeds the batch width")
        _need(chk[k].max() <= capw, "fill + count exceeds the ring width")
        raise ValueError("rows outside the ring")
    if rows is not None and n_rows > 1:
        s = np.sort(meta[0])
        _need(not np.count_nonzero(s[1:] == s[:-1]), "rows must be unique")
    return meta


def queue_append(queue: torch.Tensor, keys: torch.Tensor, rows, fill,
                 count) -> torch.Tensor:
    """Row-mapped ring append, IN PLACE: ring row rows[i] takes
    keys[i, :count[i]] at columns fill[i]...  queue (T, capw) uint32;
    keys (R, N); rows/fill/count (R,) host integers, rows unique.  On
    CUDA the meta reaches the kernel by value: no device tensor, no
    copy."""
    kind = _device_kind(queue, keys)
    meta = _append_meta(queue, keys, rows, fill, count)
    if kind == "cpu":
        return ref.queue_append_plain(queue, keys,
                                      *map(torch.from_numpy, meta))
    _keys_ok("keys", keys)
    rc = build.load().cml_queue_append(
        queue.data_ptr(), queue.shape[1], keys.data_ptr(), keys.shape[0],
        keys.shape[1], meta.ctypes.data, _stream(queue.device))
    _check_cuda("queue_append", rc)
    queue_append.launches += 1
    return queue


queue_append.launches = 0


def queue_append_dense(queue: torch.Tensor, keys: torch.Tensor, fill,
                       count) -> torch.Tensor:
    """Whole-plane ring append (batch row i -> ring row i), IN PLACE."""
    kind = _device_kind(queue, keys)
    meta = _append_meta(queue, keys, None, fill, count)
    if kind == "cpu":
        return ref.queue_append_dense_plain(queue, keys,
                                            *map(torch.from_numpy, meta))
    _keys_ok("keys", keys)
    rc = build.load().cml_queue_append_dense(
        queue.data_ptr(), queue.shape[1], keys.data_ptr(), queue.shape[0],
        keys.shape[1], meta.ctypes.data, _stream(queue.device))
    _check_cuda("queue_append_dense", rc)
    queue_append_dense.launches += 1
    return queue


queue_append_dense.launches = 0

KERNELS = (fused_query, fused_update_score, queue_append, queue_append_dense,
           fused_update, fused_update_rows, window_query, window_query_stacked,
           window_query_stacked_rows)


def kernel_launches() -> dict[str, int]:
    """{kernel wrapper name: launches} since the last reset."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_kernel_launches() -> None:
    for k in KERNELS:
        k.launches = 0
