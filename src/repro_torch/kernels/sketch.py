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
`reset_kernel_launches`).

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

Row maps of the kernels added after the first four (`fused_update_rows`,
`window_query_stacked_rows`) are host integers, checked on the host
(range, and uniqueness where the kernel writes) and uploaded by the
wrapper.  The ring appends' per-row meta (rows, fill, count) are host
integers too, checked on the host and passed to the kernel by value in
its parameter block: an append makes no device tensor and no copy.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.counters import CounterSpec
from repro_torch.kernels import build, ref

CHUNK = 1024   # keys per sequential update step: part of the semantics
MAX_DEPTH = 8  # CML_MAX_DEPTH in csrc/common.cuh

_KEY_DTYPES = (torch.uint32, torch.int32)


def _seed_tensor(seeds: tuple, device) -> torch.Tensor:
    return torch.tensor(seeds, dtype=torch.int64, device=device)


def _seed_array(seeds: tuple):
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


def _table_geometry(tables: torch.Tensor, width: int, counter: CounterSpec,
                    cpl: int) -> int:
    """Validate a (T, d, sw) table stack; return 32-bit words per row."""
    _need(tables.dim() == 3, f"tables must be (T, d, sw), got "
                             f"{tuple(tables.shape)}")
    want = torch.uint32 if cpl > 1 else counter.dtype
    _need(tables.dtype == want, f"tables dtype {tables.dtype}, expected "
                                f"{want}")
    _need(tables.shape[2] * cpl == width,
          f"table rows hold {tables.shape[2] * cpl} cells, width {width}")
    _need(1 <= tables.shape[1] <= MAX_DEPTH,
          f"depth {tables.shape[1]} outside [1, {MAX_DEPTH}]")
    _need(tables.is_contiguous(), "tables must be contiguous")
    bits = counter.bits
    _need(width * bits % 32 == 0,
          f"kernel rows are read as 32-bit words: width {width} x {bits} "
          "bits must be a multiple of 32")
    return width * bits // 32


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
# fused update + score (the flush epoch)
# --------------------------------------------------------------------------

def fused_update_score(tables: torch.Tensor, keys: torch.Tensor,
                       mult: torch.Tensor, uniforms: torch.Tensor,
                       cand: torch.Tensor, rows: torch.Tensor, *,
                       seeds: tuple, width: int, counter: CounterSpec,
                       cpl: int = 1):
    """Single-launch flush epoch, IN PLACE on `tables`.

    tables (T, d, sw); keys/mult/uniforms (R, N) pre-deduplicated
    batches (mult == 0 entries are no-ops); cand (R, M) candidate keys;
    rows (R,) int32 target rows, unique.  Each row's update runs
    CHUNK-sequentially, then its candidates are scored against the
    updated row.  Returns (tables, float32 (R, M) estimates).
    """
    kind = _device_kind(tables, keys, mult, uniforms, cand, rows)
    wpr = _table_geometry(tables, width, counter, cpl)
    t, d, _ = tables.shape
    _need(keys.dim() == 2, f"keys must be (R, N), got {tuple(keys.shape)}")
    r, n = keys.shape
    _need(tuple(mult.shape) == (r, n) and tuple(uniforms.shape) == (r, n),
          "mult and uniforms must match keys' (R, N)")
    _need(cand.dim() == 2 and cand.shape[0] == r,
          f"cand must be (R={r}, M), got {tuple(cand.shape)}")
    _need(tuple(rows.shape) == (r,), f"rows must be (R={r},)")
    _need(len(seeds) == d, f"{len(seeds)} seeds for depth {d}")
    if kind == "cpu":
        return ref.update_score_rows_ref(
            tables, keys, mult, uniforms, rows, cand,
            _seed_tensor(seeds, "cpu"), counter, CHUNK, cpl=cpl)
    m = cand.shape[1]
    _keys_ok("keys", keys, (r, n))
    _keys_ok("cand", cand, (r, m))
    for name, x in (("mult", mult), ("uniforms", uniforms)):
        _need(x.dtype == torch.float32 and x.is_contiguous(),
              f"{name} must be contiguous float32")
    _need(rows.dtype == torch.int32 and rows.is_contiguous(),
          "rows must be contiguous int32")
    est = torch.empty((r, m), dtype=torch.float32, device=tables.device)
    rc = build.load().cml_fused_update_score(
        tables.data_ptr(), d, wpr, rows.data_ptr(), r, keys.data_ptr(),
        mult.data_ptr(), uniforms.data_ptr(), n, cand.data_ptr(),
        est.data_ptr(), m, _seed_array(seeds), width,
        *_counter_args(counter), _stream(tables.device))
    _check_cuda("fused_update_score", rc)
    fused_update_score.launches += 1
    return tables, est


fused_update_score.launches = 0


def _float_ok(name: str, x: torch.Tensor, shape) -> None:
    _need(x.dtype == torch.float32 and x.is_contiguous(),
          f"{name} must be contiguous float32")
    _need(tuple(x.shape) == tuple(shape),
          f"{name} shape {tuple(x.shape)}, expected {tuple(shape)}")


def _host_rows(rows, limit: int, unique: bool) -> np.ndarray:
    rows = np.asarray(rows, np.int64).reshape(-1)
    _need(bool(((rows >= 0) & (rows < limit)).all()),
          f"rows outside [0, {limit})")
    if unique:
        _need(np.unique(rows).size == rows.size, "rows must be unique")
    return rows


def _rows_device(rows: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(rows.astype(np.int32)).to(device)


def _update_batch(tables, keys, mult, uniforms, n_rows, seeds):
    _need(keys.dim() == 2 and keys.shape[0] == n_rows,
          f"keys must be (R={n_rows}, N), got {tuple(keys.shape)}")
    _need(tuple(mult.shape) == tuple(keys.shape)
          and tuple(uniforms.shape) == tuple(keys.shape),
          "mult and uniforms must match keys' (R, N)")
    _need(len(seeds) == tables.shape[1],
          f"{len(seeds)} seeds for depth {tables.shape[1]}")


def _update_cuda_ok(keys, mult, uniforms) -> None:
    _keys_ok("keys", keys, keys.shape)
    _float_ok("mult", mult, keys.shape)
    _float_ok("uniforms", uniforms, keys.shape)


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
    _update_batch(tables, keys, mult, uniforms, rows.shape[0], seeds)
    d = tables.shape[1]
    if kind == "cpu":
        return ref.fused_update_rows_plain(
            tables, keys, mult, uniforms, torch.from_numpy(rows),
            _seed_tensor(seeds, "cpu"), counter, CHUNK, cpl)
    _update_cuda_ok(keys, mult, uniforms)
    rows_d = _rows_device(rows, tables.device)
    rc = build.load().cml_fused_update_rows(
        tables.data_ptr(), d, wpr, rows_d.data_ptr(), rows.shape[0],
        keys.data_ptr(), mult.data_ptr(), uniforms.data_ptr(), keys.shape[1],
        _seed_array(seeds), width, *_counter_args(counter),
        _stream(tables.device))
    _check_cuda("fused_update_rows", rc)
    fused_update_rows.launches += 1
    return tables


fused_update_rows.launches = 0


def fused_update(tables: torch.Tensor, keys: torch.Tensor,
                 mult: torch.Tensor, uniforms: torch.Tensor, *,
                 seeds: tuple, width: int, counter: CounterSpec,
                 cpl: int = 1) -> torch.Tensor:
    """Dense multi-tenant update, IN PLACE: batch row i lands in table i,
    CHUNK-sequentially.  tables (T, d, sw); keys/mult/uniforms (T, N)."""
    kind = _device_kind(tables, keys, mult, uniforms)
    wpr = _table_geometry(tables, width, counter, cpl)
    t, d, _ = tables.shape
    _update_batch(tables, keys, mult, uniforms, t, seeds)
    if kind == "cpu":
        return ref.fused_update_plain(tables, keys, mult, uniforms,
                                      _seed_tensor(seeds, "cpu"), counter,
                                      CHUNK, cpl)
    _update_cuda_ok(keys, mult, uniforms)
    rc = build.load().cml_fused_update(
        tables.data_ptr(), d, wpr, t, keys.data_ptr(), mult.data_ptr(),
        uniforms.data_ptr(), keys.shape[1], _seed_array(seeds), width,
        *_counter_args(counter), _stream(tables.device))
    _check_cuda("fused_update", rc)
    fused_update.launches += 1
    return tables


fused_update.launches = 0


# --------------------------------------------------------------------------
# window queries
# --------------------------------------------------------------------------

_MODES = {"sum": 0, "max": 1}


def _window_geometry(tables: torch.Tensor, width: int, counter: CounterSpec,
                     cpl: int, mode: str) -> int:
    """Validate a (R, B, d, sw) ring stack; return 32-bit words per row."""
    _need(mode in _MODES, f"unknown window query mode {mode!r}")
    _need(tables.dim() == 4, f"rings must be (R, B, d, sw), got "
                             f"{tuple(tables.shape)}")
    _need(tables.shape[1] >= 1, "need at least one bucket")
    _need(tables.is_contiguous(), "rings must be contiguous")
    return _table_geometry(tables.view((-1,) + tuple(tables.shape[2:])),
                           width, counter, cpl)


def _window_launch(wrapper, tables, keys, weights, rows, seeds, width,
                   counter, mode, cpl):
    """Check a window query's inputs (tables (R or T, B, d, sw), keys
    (R, N), weights (R, B), rows None or (R,) host ints); run the plain
    version on the CPU, launch `wrapper`'s kernel on CUDA."""
    kind = _device_kind(tables, keys, weights)
    wpr = _window_geometry(tables, width, counter, cpl, mode)
    _, b, d, _ = tables.shape
    n_rings = tables.shape[0] if rows is None else rows.shape[0]
    _need(keys.dim() == 2 and keys.shape[0] == n_rings,
          f"keys must be (R={n_rings}, N), got {tuple(keys.shape)}")
    _need(tuple(weights.shape) == (n_rings, b),
          f"weights must be (R={n_rings}, B={b}), got "
          f"{tuple(weights.shape)}")
    _need(len(seeds) == d, f"{len(seeds)} seeds for depth {d}")
    if kind == "cpu":
        rows_t = (torch.arange(n_rings) if rows is None
                  else torch.from_numpy(rows))
        return ref.window_query_stacked_rows_plain(
            tables, keys, weights, rows_t, _seed_tensor(seeds, "cpu"), width,
            counter, mode, cpl)
    n = keys.shape[1]
    _keys_ok("keys", keys, (n_rings, n))
    _float_ok("weights", weights, (n_rings, b))
    out = torch.empty((n_rings, n), dtype=torch.float32, device=tables.device)
    rows_d = None if rows is None else _rows_device(rows, tables.device)
    rc = getattr(build.load(), "cml_" + wrapper.__name__)(
        tables.data_ptr(), n_rings, b, d, wpr,
        None if rows_d is None else rows_d.data_ptr(), keys.data_ptr(), n,
        weights.data_ptr(), out.data_ptr(), _MODES[mode], _seed_array(seeds),
        width, *_counter_args(counter), _stream(tables.device))
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
    _need(tables.dim() == 3 and keys.dim() == 1 and weights.dim() == 1,
          "window_query takes tables (B, d, sw), keys (N,), weights (B,)")
    return _window_launch(window_query, tables[None], keys[None],
                          weights[None], None, seeds, width, counter, mode,
                          cpl)[0]


window_query.launches = 0


def window_query_stacked(tables: torch.Tensor, keys: torch.Tensor,
                         weights: torch.Tensor, *, seeds: tuple, width: int,
                         counter: CounterSpec, mode: str = "sum",
                         cpl: int = 1) -> torch.Tensor:
    """R rings in one launch: tables (R, B, d, sw), keys (R, N), weights
    (R, B) -> float32 (R, N)."""
    return _window_launch(window_query_stacked, tables, keys, weights, None,
                          seeds, width, counter, mode, cpl)


window_query_stacked.launches = 0


def window_query_stacked_rows(tables: torch.Tensor, keys: torch.Tensor,
                              weights: torch.Tensor, rows, *, seeds: tuple,
                              width: int, counter: CounterSpec,
                              mode: str = "sum", cpl: int = 1
                              ) -> torch.Tensor:
    """Rings rows[i] (host integers) of the native (T, B, d, sw) window
    leaf, read in place: keys (R, N), weights (R, B) -> float32 (R, N)."""
    _need(tables.dim() == 4, f"rings must be (T, B, d, sw), got "
                             f"{tuple(tables.shape)}")
    rows = _host_rows(rows, tables.shape[0], unique=False)
    return _window_launch(window_query_stacked_rows, tables, keys, weights,
                          rows, seeds, width, counter, mode, cpl)


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
