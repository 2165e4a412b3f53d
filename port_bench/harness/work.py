"""The least time the chip could take for an entry's inputs: the yardstick
of the roofline shares.

Copied from the port's `chip_smoke.py` (`sectors`, its peaks and its
bound convention; no code path shares them): each input byte read once,
each output byte written once, a random access to a table one 32-byte
sector.  For a call that hands an entry

  * update (`update_score_rows`, `update_rows`): its live keys are read
    (4 bytes each), each distinct (table row, depth row, sector) that a
    live key hashes into is read and written (64 bytes); candidates to
    score are read (4 bytes each), each further sector they hash into is
    read (32 bytes), and their answers written (4 bytes each); each live
    key draws one uniform (85 integer operations: threefry's 20 rounds,
    key injections, the float step, the index);
  * query (`query_many`): the probes read once (4 bytes each), each
    distinct (tenant, depth row, sector) read (32 bytes), the answers
    written (4 bytes each).

The least time is the larger of bytes over the memory's bandwidth and
operations over float32's peak (the card's data sheet, below).  The
work depends only on the inputs, so it reads the same whatever
implements the entry.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import sketch as rs

SECTOR = 32
DRAW_OPS = 85
# NVIDIA's data sheet, H100 SXM (dense, no sparsity), at 700 W
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                                   "fp32_ops_per_s": 67e12}}


def _sector_ids(keys: torch.Tensor, rows: torch.Tensor, geo: dict
                ) -> torch.Tensor:
    """Flat (table row, depth row, sector) ids of int64 keys (R, N) in
    table rows `rows` (R,)."""
    cols = rs.row_hashes(keys, rs.row_seeds(geo["seed"], geo["depth"]),
                         geo["width"])                          # (d, R, N)
    sec = cols * (geo["bits"] // 8) // SECTOR
    d = cols.shape[0]
    di = torch.arange(d, device=keys.device)[:, None, None]
    rid = rows.to(keys.device)[None, :, None] * d + di
    return (rid * (1 << 36) + sec).reshape(-1)


def _i64(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32).to(torch.int64) & 0xFFFF_FFFF


def update_work(call: dict) -> tuple:
    """(bytes, operations) of one update call's inputs."""
    geo = call["geometry"]
    keys = _i64(call["keys"])
    live = (torch.ones_like(keys, dtype=torch.bool) if call["weights"] is None
            else call["weights"] > 0)
    rows = torch.as_tensor(call["rows"], device=keys.device)
    r, n = keys.shape
    ids = _sector_ids(keys, rows, geo)
    live_ids = ids[live[None].expand(geo["depth"], r, n).reshape(-1)]
    upd = torch.unique(live_ids)
    n_live = int(live.sum())
    nbytes = 4 * n_live + 2 * SECTOR * upd.numel()
    cand = call.get("cand")
    if cand is not None:
        ck = _i64(cand)
        both = torch.unique(torch.cat([upd, _sector_ids(ck, rows, geo)]))
        nbytes += 8 * ck.numel() + SECTOR * (both.numel() - upd.numel())
    return nbytes, DRAW_OPS * n_live


def query_work(call: dict) -> tuple:
    """(bytes, operations) of one query call's inputs: probes shared by
    every tenant."""
    geo = call["geometry"]
    probes = torch.as_tensor(np.asarray(call["probes"]).astype(np.int64))
    ids = torch.unique(_sector_ids(probes[None], torch.zeros(1, dtype=torch.int64),
                                   geo))
    t = call["tenants"]
    return 4 * probes.numel() + SECTOR * ids.numel() * t \
        + 4 * probes.numel() * t, 0


def least_seconds(nbytes: float, ops: float, kind: str):
    """The least time of the work on card `kind`, or None off the table."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["fp32_ops_per_s"])
