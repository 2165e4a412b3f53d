"""Plain PyTorch versions of the hand-written sketch kernels.

Counterpart of `repro/kernels/ref.py`.  Every function here computes what
one CUDA kernel in `kernels/csrc/` computes, with ordinary tensor ops, on
any device: the CPU engine of `kernels.sketch`'s wrappers, and the
yardstick the kernels are held against on the card.

Semantics (shared with the reference's Pallas kernels):

  * query: per key, d seeded fmix32 hashes, a gather per row (packed
    tables: the containing uint32 lane, shifted and masked), min over
    rows, Morris decode.
  * update: CHUNK-sequential conservative update.  Within a chunk every
    key reads the row minima from before the chunk, writes resolve by
    max, and entries with mult == 0 write nothing; each chunk sees all
    earlier chunks' writes.
  * window query: per key and bucket b = 0..B-1 in order, the query's
    estimate times the ring's weight for b; "sum" starts from bucket 0
    and adds, "max" keeps the largest.
  * queue append: queue[rows[i], fill[i] + j] = keys[i, j] for
    j < count[i]; every other ring cell keeps its value.

Cell states are int64 values while they are worked on; tables stay in
their storage dtype and are written in place where the kernel writes in
place.
"""
from __future__ import annotations

import torch

from repro_torch.core.counters import (CounterSpec, from_i64, pack_table,
                                       signed_view, to_i64, unpack_table)
from repro_torch.core import sketch as sk
from repro_torch.core.hashing import as_i64, row_hashes


def read_cells(tables: torch.Tensor, t_idx: torch.Tensor, cols: torch.Tensor,
               bits: int, cpl: int) -> torch.Tensor:
    """Cell states (int64) of stored tables (T, d, sw) at logical columns.

    cols (d, R, N) int64 logical columns; t_idx (R,) table rows.  With
    cpl > 1 the stored axis is packed uint32 lanes: lane col // cpl,
    shifted right by (col % cpl) * bits and masked.
    """
    d = cols.shape[0]
    ti = t_idx.reshape(1, -1, 1)
    di = torch.arange(d, device=cols.device).reshape(-1, 1, 1)
    raw = to_i64(signed_view(tables)[ti, di, cols // cpl].view(tables.dtype))
    if cpl == 1:
        return raw
    return (raw >> ((cols % cpl) * bits)) & ((1 << bits) - 1)


def fused_query_plain(tables: torch.Tensor, keys: torch.Tensor,
                      row_seeds: torch.Tensor, width: int,
                      counter: CounterSpec, cpl: int = 1) -> torch.Tensor:
    """tables (T, d, sw), keys (T, N) -> float32 (T, N) estimates."""
    cols = row_hashes(keys, row_seeds, width)                 # (d, T, N)
    t_idx = torch.arange(tables.shape[0], device=cols.device)
    vals = read_cells(tables, t_idx, cols, counter.bits, cpl)
    return counter.decode(vals.min(dim=0).values)


def query_ref(table: torch.Tensor, keys: torch.Tensor,
              row_seeds: torch.Tensor, counter: CounterSpec,
              cpl: int = 1) -> torch.Tensor:
    """One table (d, sw), keys (N,) -> float32 (N,)."""
    width = table.shape[-1] * cpl
    return fused_query_plain(table[None], keys.reshape(1, -1), row_seeds,
                             width, counter, cpl)[0]


def _chunked(cells, keys, mult, uniforms, row_seeds, counter, chunk):
    n = keys.shape[-1]
    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        sk.conservative_update_(cells, keys[:, sl], mult[:, sl],
                                uniforms[:, sl], row_seeds, counter)


def _to_cells(table: torch.Tensor, counter: CounterSpec, cpl: int):
    return unpack_table(table, counter.bits) if cpl > 1 else to_i64(table)


def _from_cells(cells: torch.Tensor, counter: CounterSpec, cpl: int):
    return (pack_table(cells, counter.bits) if cpl > 1
            else from_i64(cells, counter.dtype))


def update_ref(table: torch.Tensor, keys: torch.Tensor, mult: torch.Tensor,
               uniforms: torch.Tensor, row_seeds: torch.Tensor,
               counter: CounterSpec, cpl: int = 1) -> torch.Tensor:
    """One-shot batched conservative update of one table (d, sw); returns
    the new table in its storage layout."""
    cells = _to_cells(table, counter, cpl)[None]
    sk.conservative_update_(cells, as_i64(keys)[None], mult[None],
                            uniforms[None], row_seeds, counter)
    return _from_cells(cells[0], counter, cpl)


def update_chunked_ref(table: torch.Tensor, keys: torch.Tensor,
                       mult: torch.Tensor, uniforms: torch.Tensor,
                       row_seeds: torch.Tensor, counter: CounterSpec,
                       chunk: int, cpl: int = 1) -> torch.Tensor:
    """`update_ref` applied in `chunk`-sized slices, sequentially."""
    cells = _to_cells(table, counter, cpl)[None]
    _chunked(cells, as_i64(keys)[None], mult[None], uniforms[None],
             row_seeds, counter, chunk)
    return _from_cells(cells[0], counter, cpl)


def fused_update_rows_plain(tables: torch.Tensor, keys: torch.Tensor,
                            mult: torch.Tensor, uniforms: torch.Tensor,
                            rows: torch.Tensor, row_seeds: torch.Tensor,
                            counter: CounterSpec, chunk: int, cpl: int = 1
                            ) -> torch.Tensor:
    """Plain version of the row-mapped update kernel.

    tables (T, d, sw) storage, updated IN PLACE at `rows` (R,) (unique);
    keys/mult/uniforms (R, N) pre-deduplicated batches.  Each row's
    update runs chunk-sequentially; the other T - R tables are untouched.
    """
    rows = rows.to(device=tables.device, dtype=torch.int64)
    cells = _to_cells(signed_view(tables)[rows].view(tables.dtype),
                      counter, cpl)                             # (R, d, w)
    _chunked(cells, as_i64(keys), mult, uniforms, row_seeds, counter, chunk)
    signed_view(tables)[rows] = signed_view(_from_cells(cells, counter, cpl))
    return tables


def fused_update_plain(tables: torch.Tensor, keys: torch.Tensor,
                       mult: torch.Tensor, uniforms: torch.Tensor,
                       row_seeds: torch.Tensor, counter: CounterSpec,
                       chunk: int, cpl: int = 1) -> torch.Tensor:
    """Plain version of the dense update kernel: batch row i lands in
    table i, in place.  tables (T, d, sw); keys/mult/uniforms (T, N)."""
    rows = torch.arange(tables.shape[0], device=tables.device)
    return fused_update_rows_plain(tables, keys, mult, uniforms, rows,
                                   row_seeds, counter, chunk, cpl)


def update_score_rows_ref(tables: torch.Tensor, keys: torch.Tensor,
                          mult: torch.Tensor, uniforms: torch.Tensor,
                          rows: torch.Tensor, cand: torch.Tensor,
                          row_seeds: torch.Tensor, counter: CounterSpec,
                          chunk: int, cpl: int = 1):
    """Plain version of the fused update + score kernel.

    `fused_update_rows_plain` (in place), then cand (R, M) scored
    against the updated rows.  Returns (tables, float32 (R, M)).
    """
    fused_update_rows_plain(tables, keys, mult, uniforms, rows, row_seeds,
                            counter, chunk, cpl)
    cols = row_hashes(cand, row_seeds, tables.shape[-1] * cpl)  # (d, R, M)
    vals = read_cells(tables, rows.to(device=tables.device,
                                      dtype=torch.int64),
                      cols, counter.bits, cpl)
    return tables, counter.decode(vals.min(dim=0).values)


def window_query_stacked_rows_plain(tables: torch.Tensor, keys: torch.Tensor,
                                    weights: torch.Tensor,
                                    rows: torch.Tensor,
                                    row_seeds: torch.Tensor, width: int,
                                    counter: CounterSpec, mode: str = "sum",
                                    cpl: int = 1) -> torch.Tensor:
    """Plain version of the row-mapped stacked window query.

    tables (T, B, d, sw) window leaf; rows (R,) the rings to read; keys
    (R, N); weights (R, B).  Per key, bucket b's estimate is
    decode(min over rows) * weights[r, b] (`CounterSpec.decode_scaled`,
    the reference kernel's reassociated product); "sum" starts from bucket 0's
    and adds the others in ascending bucket order, "max" keeps the
    largest.  Returns float32 (R, N).
    """
    if mode not in ("sum", "max"):
        raise ValueError(f"unknown window query mode {mode!r}")
    rows = rows.to(device=tables.device, dtype=torch.int64)
    cols = row_hashes(keys, row_seeds, width)                 # (d, R, N)
    out = None
    for b in range(tables.shape[1]):
        vals = read_cells(tables[:, b], rows, cols, counter.bits, cpl)
        est = counter.decode_scaled(vals.min(dim=0).values,
                                    weights[:, b:b + 1])
        if out is None:
            out = est
        elif mode == "sum":
            out = out + est
        else:
            out = torch.maximum(out, est)
    return out


def window_query_stacked_plain(tables: torch.Tensor, keys: torch.Tensor,
                               weights: torch.Tensor, row_seeds: torch.Tensor,
                               width: int, counter: CounterSpec,
                               mode: str = "sum", cpl: int = 1
                               ) -> torch.Tensor:
    """Plain version of the stacked window query: R rings (R, B, d, sw),
    keys (R, N), weights (R, B) -> float32 (R, N)."""
    rows = torch.arange(tables.shape[0], device=tables.device)
    return window_query_stacked_rows_plain(tables, keys, weights, rows,
                                           row_seeds, width, counter, mode,
                                           cpl)


def window_query_plain(tables: torch.Tensor, keys: torch.Tensor,
                       weights: torch.Tensor, row_seeds: torch.Tensor,
                       width: int, counter: CounterSpec, mode: str = "sum",
                       cpl: int = 1) -> torch.Tensor:
    """Plain version of the one-ring window query: tables (B, d, sw),
    keys (N,), weights (B,) -> float32 (N,)."""
    return window_query_stacked_plain(tables[None], keys.reshape(1, -1),
                                      weights[None], row_seeds, width,
                                      counter, mode, cpl)[0]


def window_query_stacked_ref(tables: torch.Tensor, keys: torch.Tensor,
                             weights: torch.Tensor, row_seeds: torch.Tensor,
                             counter: CounterSpec, mode: str = "sum",
                             cpl: int = 1) -> torch.Tensor:
    """The reference's signature of `window_query_stacked_plain` (width
    from the table's stored axis)."""
    return window_query_stacked_plain(tables, keys, weights, row_seeds,
                                      tables.shape[-1] * cpl, counter, mode,
                                      cpl)


def window_query_stacked_rows_ref(tables: torch.Tensor, keys: torch.Tensor,
                                  weights: torch.Tensor, rows: torch.Tensor,
                                  row_seeds: torch.Tensor,
                                  counter: CounterSpec, mode: str = "sum",
                                  cpl: int = 1) -> torch.Tensor:
    """The reference's signature of `window_query_stacked_rows_plain`."""
    return window_query_stacked_rows_plain(tables, keys, weights, rows,
                                           row_seeds, tables.shape[-1] * cpl,
                                           counter, mode, cpl)


def queue_append_plain(queue: torch.Tensor, keys: torch.Tensor,
                       rows: torch.Tensor, fill: torch.Tensor,
                       count: torch.Tensor) -> torch.Tensor:
    """Row-mapped ring append, in place: queue (T, capw) uint32; keys
    (R, N); rows/fill/count (R,) int64 tensors on the queue's device."""
    n = keys.shape[1]
    j = torch.arange(n, device=queue.device)[None, :]
    valid = j < count[:, None]
    dst_row = rows[:, None].expand(-1, n)[valid]
    dst_col = (fill[:, None] + j)[valid]
    src = from_i64(as_i64(keys), torch.uint32).view(torch.int32)
    signed_view(queue)[dst_row, dst_col] = src[valid]
    return queue


def queue_append_dense_plain(queue: torch.Tensor, keys: torch.Tensor,
                             fill: torch.Tensor, count: torch.Tensor
                             ) -> torch.Tensor:
    """Whole-plane ring append (row i -> ring row i), in place."""
    rows = torch.arange(queue.shape[0], device=queue.device)
    return queue_append_plain(queue, keys, rows, fill, count)
