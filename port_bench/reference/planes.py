"""The counting service's planes, as the reference follows them.

What one tenant's state does under the service's documented semantics
(`stream/service.py` of the port, as it stood when the benchmark was
defined), recomputed from the inputs the benchmark handed the service:

  * an append writes the keys into the tenant's ring after its fill;
  * a flush of the tenant's plane takes ring[:cols] (cols its fill
    rounded up to CHUNK, at most the ring's width) with weight 1 below
    the fill and 0 above, draws the uniforms of the plane's flush number
    f from the raw key (seed, f) over the (plane tenants, cols) grid at
    the tenant's row, lands the update in the tenant's table (a windowed
    tenant's: its active bucket), re-selects the heap (a windowed
    tenant's candidates scored over its whole ring), and empties the
    ring;
  * a windowed tenant's watermark moves to floor(ts / interval); a
    crossing flushes its plane first when the plane has pending events,
    then clears the buckets after the cursor, one a step, and moves the
    cursor;
  * a read flushes every plane with pending events, then answers
    decode(min over rows).

A plane's flush numbers count every flush of that plane from the start
of the run, so the reference follows every plane's bookkeeping through
the whole run and does the arithmetic only for the tenants it checks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import sketch as rs


class TenantState:
    """One checked tenant: cells (1, d, w) or a window ring (B, d, w) as
    int64, its ring of keys (capw,) int64 and its heap (K,) rows."""

    def __init__(self, cells, ring, heap=None):
        self.cells = cells
        self.ring = ring
        self.heap = heap            # (keys, estimates, filled) or None


class Plane:
    """Bookkeeping of one plane (every tenant of it), and the arithmetic
    of its checked tenants (`states`: {row: TenantState})."""

    def __init__(self, names, geo: rs.Geometry, service_seed: int,
                 capw: int, track_top, window=None):
        self.names = list(names)
        self.row = {n: i for i, n in enumerate(self.names)}
        self.geo = geo
        self.seed = int(service_seed) & rs.MASK32
        self.capw = int(capw)
        self.track_top = track_top
        self.window = window            # (buckets, interval) or None
        self.fill = np.zeros(len(self.names), np.int64)
        self.flushes = 0
        self.cursor = np.zeros(len(self.names), np.int64)
        self.epoch = [None] * len(self.names)
        self.states: dict = {}

    def pending(self) -> bool:
        return bool(self.fill.any())

    def append(self, name: str, keys: np.ndarray, land: bool = True
               ) -> None:
        """Append keys to the tenant's ring (`land` False: the control,
        which leaves them out)."""
        r = self.row[name]
        n = int(keys.size)
        if not land:
            return
        assert self.fill[r] + n <= self.capw, "ring overflow"
        st = self.states.get(r)
        if st is not None:
            st.ring[self.fill[r]:self.fill[r] + n] = torch.as_tensor(
                keys.astype(np.int64))
        self.fill[r] += n

    def flush(self) -> None:
        if not self.pending():
            return
        key = (self.seed, self.flushes)
        self.flushes += 1
        for r, st in self.states.items():
            if self.fill[r]:
                self._land(r, st, key)
        self.fill[:] = 0

    def _land(self, r: int, st: TenantState, key) -> None:
        cols = min(self.capw, rs.CHUNK * -(-int(self.fill[r]) // rs.CHUNK))
        keys = st.ring[None, :cols]
        weights = (torch.arange(cols)[None]
                   < int(self.fill[r])).to(torch.float32)
        uni = rs.uniform_rows(key, len(self.names), cols, [r])
        if self.window is None:
            rs.update(st.cells, keys, weights, uni, self.geo)
        else:
            c = int(self.cursor[r])
            bucket = st.cells[c:c + 1].clone()
            rs.update(bucket, keys, weights, uni, self.geo)
            st.cells[c] = bucket[0]
        if st.heap is None:
            return
        hk, he, hf = st.heap
        cand = torch.cat([hk[None], keys], dim=1)
        valid = torch.cat([hf[None], weights > 0], dim=1)
        if self.window is None:
            est = rs.query(st.cells, cand, self.geo)
        else:
            w = torch.as_tensor(rs.full_window_weights(
                int(self.cursor[r]), self.window[0]))
            est = rs.window_query(st.cells[None], cand, w[None], self.geo)
        k, e, f = rs.select(cand, valid, est, self.track_top)
        st.heap = (k[0], e[0], f[0])

    def advance(self, names, ts: float) -> None:
        """Watermark step of the listed windowed tenants to own `ts`."""
        buckets, interval = self.window
        target = int(math.floor(float(ts) / interval))
        steps = {}
        for n in names:
            r = self.row[n]
            if self.epoch[r] is None:
                self.epoch[r] = target
                continue
            assert target >= self.epoch[r], "non-monotone event time"
            if target > self.epoch[r]:
                steps[r] = target - self.epoch[r]
        if not steps:
            return
        if self.fill[list(steps)].any():
            self.flush()
        for r, s in steps.items():
            st = self.states.get(r)
            if st is not None:
                mask = rs.rotation_mask(int(self.cursor[r]), s, buckets)
                st.cells[torch.as_tensor(np.flatnonzero(mask))] = 0
            self.cursor[r] = (self.cursor[r] + s) % buckets
            self.epoch[r] += s

    def answers(self, r: int, probes: torch.Tensor) -> torch.Tensor:
        """float32 (N,) estimates of checked tenant row r at probes."""
        st = self.states[r]
        return rs.query(st.cells, probes[None], self.geo)[0]
