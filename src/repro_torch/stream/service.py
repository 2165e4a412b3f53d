"""Multi-tenant counting service: spec-bucketed planes + device-resident ingest.

PyTorch counterpart of `repro/stream/service.py`, without tiering:

  * Tenants sharing one `SketchSpec` stack into a `TenantPlane` whose
    tables form one (T, d, w) device tensor; tenants with another spec
    land in their own plane, and `query_all` fans across planes.
  * Windowed tenants (`add_tenant(window=WindowSpec)`) live in a
    `WindowPlane` whose rings form ONE (T, B, d, w) leaf; per-tenant
    `WindowedSketch`es are views of it.  Event time (`enqueue(..., ts=)`)
    drives watermark rotation: every crossing tenant of a plane rotates
    in ONE masked in-place zeroing (`ops.window_advance_rows`), and
    buffered events flush into their own interval's bucket first.
  * The ingest queue is device-resident: each plane owns a (T, capw)
    uint32 ring appended in place by `ops.queue_append` (the dense kernel
    when a microbatch covers the whole plane, the row-mapped one
    otherwise).  The host keeps a deterministic fill mirror (and cursor
    and watermark mirrors), so the ring never crosses back to the host.
  * A tracked flush (`track_top=K`) is one `ops.update_score_rows` per
    fill class: the fused kernel lands the chunk-sequential conservative
    update of the active rows and scores each row's candidate union in
    the same launch; the scores re-select the stacked (T, K) `TopK`
    tracker.  Without tracking, an epoch where every tenant is active in
    one fill class is one `ops.update_many` (the dense kernel), any other
    one `ops.update_rows` per fill class.  A window flush lands each
    pending tenant's batch in its active bucket through `ops.update_rows`
    on the flat (T*B, d, w) view of the leaf, in place, and refreshes the
    tracker with one row-mapped `ops.window_query_stacked`.
    `flush(dense=True)` runs the reference's whole-plane baseline (the
    parity oracle).
  * Each plane draws its flush uniforms from the raw threefry key
    (seed, flush#), bit-identical to the reference's draw.

Reads are read-your-writes: they flush the plane they touch first.  A
read on a clean plane issues no synchronize: its probes go up through
`core/staging.py` (`query_all` uploads them once for every plane), a
window plane keeps its full-window weights until a cursor moves, and
`query_all` hands a window plane's shared (N,) probes to the stacked
query as they are (ring stride 0).

The tracker also feeds the admission plane:
`add_tenant(admission=AdmissionSpec(...))` + `admit(name, ids)` map raw
ids to embedding rows, admitting exactly the tracked candidates whose
estimates clear the threshold (`core/admission.admit_tracked`, an (N, K)
compare on the device); a windowed tenant re-scores its heap against
the ring first.  On a clean plane an admit issues no synchronize.

`snapshot` / `restore` write and read the reference's checkpoint
(`train/checkpoint.py`, manifest v8; either package restores the other's
files): tables, rings, fills, trackers, window cursors and watermarks,
the PRNG lanes, the admission policies and the metrics.  `restore`
reads manifests v1-v8 (v1's host queue replays into the device ring),
re-packs the storage on load (`packed=`) and re-arms the trackers at
another width (`track_top=`).

The port updates tables, leaves and rings in place (the reference
donates them); the results are the same.  Tiering (a tiered manifest
included) and the accuracy probe are later slices and raise
`NotImplementedError`.  Entry points run on CUDA unless `device="cpu"`;
without a GPU a CUDA service raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import admission as adm
from repro_torch.core import sketch as sk
from repro_torch.core import staging
from repro_torch.core import topk
from repro_torch.core.counters import (CounterSpec, signed_view, to_numpy,
                                       zeros)
from repro_torch.core.sketch import Sketch, SketchSpec
from repro_torch.kernels import ops
from repro_torch.stream import tiering
from repro_torch.stream import window as w
from repro_torch.train import checkpoint

_as_keys = sk.as_uint32_keys

VERSION = 8  # the checkpoint manifest's schema, as the reference writes it

LATER = {
    "tier": "hot/cold tiering (stream/tiering.py TierSpec) is a later slice",
    "probe": "the accuracy probe (obs/probes.py) is a later slice",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"not in this slice of the port: {LATER[what]}")


def _spec_meta(spec: SketchSpec) -> dict:
    c = spec.counter
    return {"width": spec.width, "depth": spec.depth, "seed": spec.seed,
            "packed": spec.packed,
            "counter": {"kind": c.kind, "base": c.base, "bits": c.bits}}


def _spec_from_meta(meta: dict) -> SketchSpec:
    # pre-v6 manifests carry no "packed" flag: their tables were stored
    # one cell a lane, which is packed=False
    return SketchSpec(width=meta["width"], depth=meta["depth"],
                      seed=meta["seed"], packed=meta.get("packed", False),
                      counter=CounterSpec(**meta["counter"]))


def _repack(tables: torch.Tensor, old: SketchSpec, new: SketchSpec
            ) -> torch.Tensor:
    """A (T, ..., d, sw) stack converted from `old`'s storage layout to
    `new`'s, cell for cell, one leading row at a time (the int64 cell
    states of one row at most are held at once)."""
    out = zeros(tuple(tables.shape[:-1]) + (new.storage_width,),
                new.storage_dtype, tables.device)
    for i in range(tables.shape[0]):
        signed_view(out)[i] = signed_view(
            sk.storage_table(sk.logical_table(tables[i], old), new))
    return out


def resolve_device(device) -> torch.device:
    """None means CUDA.  A CUDA device without a GPU raises: entry points
    never carry on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _RngLane:
    """Per-plane counter-based PRNG lane: flush number f draws the raw
    threefry key (seed, f).  The lane state is one integer."""

    def __init__(self, seed: int, draws: int = 0):
        self.seed = int(seed) & 0xFFFF_FFFF
        self.draws = int(draws)

    def next(self) -> np.ndarray:
        key = np.asarray([self.seed, self.draws], np.uint32)
        self.draws += 1
        return key


class _DeviceRing:
    """(T, capw) device ring + deterministic host fill mirror.

    Appends stage their keys through a `HostStaging` of two slots the ring
    owns and one device buffer it reuses: on CUDA the slots are pinned, so
    an append is one asynchronous copy and one kernel launch, and the host
    waits only when it is two appends ahead of the copies; on the CPU, the
    same packing into plain host slots, which the append reads in place.
    """

    SLOTS = 2

    def __init__(self, capacity: int, device, engine: str):
        self.capacity = int(capacity)
        self.device = device
        self.engine = engine
        self.queue = ops.queue_init(0, capacity, device)
        self.fill = np.zeros((0,), np.int64)
        self._cuda = device.type == "cuda"
        self._staging = staging.HostStaging(device, self.SLOTS, torch.int32)
        self._dev = (torch.empty(0, dtype=torch.int32, device=device)
                     if self._cuda else None)

    @property
    def _host(self) -> list:
        return self._staging.host

    def _stage(self, batches: Sequence[np.ndarray]) -> torch.Tensor:
        """Pack the batches into the next slot as rows of the
        CHUNK-quantized width n_pad (the padding keeps whatever the slot
        held: an append reads no key past its row's count); return them as
        a contiguous (R, n_pad) uint32 tensor on the ring's device."""
        n = max(b.size for b in batches)
        n_pad = ops.CHUNK * -(-n // ops.CHUNK)  # CHUNK-quantized launches
        size = len(batches) * n_pad
        host = self._staging.stage(size)
        keys = host.numpy().view(np.uint32).reshape(len(batches), n_pad)
        for i, b in enumerate(batches):
            keys[i, :b.size] = b
        if self._cuda:
            if self._dev.numel() < size:
                self._dev = torch.empty(size, dtype=torch.int32,
                                        device=self.device)
            host = self._staging.send(host, self._dev[:size])
        return host.view(len(batches), n_pad).view(torch.uint32)

    def add_row(self) -> int:
        t = self.queue.shape[0]
        row = ops.queue_init(1, self.capacity, self.device)
        self.queue = torch.cat([signed_view(self.queue),
                                signed_view(row)]).view(torch.uint32)
        self.fill = np.concatenate([self.fill, np.zeros((1,), np.int64)])
        return t

    def free(self, row: int) -> int:
        return self.capacity - int(self.fill[row])

    def append(self, rows: Sequence[int], batches: Sequence[np.ndarray]
               ) -> None:
        """Append per-row microbatches (caller guarantees they fit): one
        host staging pass, one asynchronous upload from pinned memory, ONE
        append launch; with the kernels, nothing synchronizes."""
        rows = np.asarray(rows, np.int64)
        count = np.fromiter((b.size for b in batches), np.int64,
                            len(batches))
        self.queue = ops.queue_append(self.queue, self._stage(batches), rows,
                                      self.fill[rows], count,
                                      engine=self.engine)
        self.fill[rows] += count  # rows are unique (the append checks)

    def live_slice(self, rows=None):
        """(queue[:, :cols], (T, cols) live mask) for a whole-plane flush,
        cols the fullest row's fill rounded up to CHUNK; with `rows`, just
        those rows (`ops.flush_rows_inputs`)."""
        fill = self.fill if rows is None else self.fill[rows]
        cols = min(self.queue.shape[1],
                   ops.CHUNK * -(-int(fill.max()) // ops.CHUNK))
        if rows is None:
            return ops.flush_inputs(self.queue, fill, cols)
        return ops.flush_rows_inputs(self.queue, fill, rows, cols)

    def class_slice(self, rows, cols: int):
        """(queue[rows, :cols], (R, cols) live mask) for one fill class."""
        return ops.flush_rows_inputs(self.queue, self.fill[rows], rows, cols)

    def reset(self) -> None:
        self.fill[:] = 0


class _TelemetryMixin:
    """Per-plane instruments + tracer (ring occupancy gauge with
    high-water, event/flush counters, tenant-count gauge)."""

    def _init_telemetry(self, metrics: Optional[obs.MetricsRegistry],
                        tracer: Optional[obs.Tracer], label: str) -> None:
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self.tracer = tracer if tracer is not None else obs.Tracer()
        self.label = label
        self._m_events = self.metrics.counter("plane_events", plane=label)
        self._m_flushes = self.metrics.counter("plane_flushes", plane=label)
        self._g_fill = self.metrics.gauge("ring_fill", plane=label)
        self._g_tenants = self.metrics.gauge("plane_tenants", plane=label)

    def note_append(self) -> None:
        self._g_fill.set(self.pending())

    def _note_flush(self, pending: int) -> None:
        self._m_events.inc(int(pending))
        self._m_flushes.inc()
        self._g_fill.set(0)


class _TrackerMixin:
    """Stacked (T, K) heavy-hitter tracker (None without tracking)."""

    track_top: Optional[int]
    tracker: Optional[topk.TopK]

    def _init_tracker(self, track_top: Optional[int], device) -> None:
        self.track_top = track_top
        self.tracker = (None if track_top is None
                        else topk.init_stacked(0, track_top, device))

    def _grow_tracker(self, device) -> None:
        if self.tracker is None:
            return
        tk, new = self.tracker, topk.init_stacked(1, self.track_top, device)
        self.tracker = topk.TopK(
            keys=torch.cat([signed_view(tk.keys),
                            signed_view(new.keys)]).view(torch.uint32),
            estimates=torch.cat([tk.estimates, new.estimates]),
            filled=torch.cat([tk.filled, new.filled]))

    def _scatter_tracker(self, rows: torch.Tensor, new: topk.TopK) -> None:
        tk = self.tracker
        signed_view(tk.keys)[rows] = signed_view(new.keys)
        tk.estimates[rows] = new.estimates
        tk.filled[rows] = new.filled

    def _tracker_rows(self, rows: torch.Tensor) -> topk.TopK:
        tk = self.tracker
        return topk.TopK(keys=signed_view(tk.keys)[rows].view(torch.uint32),
                         estimates=tk.estimates[rows],
                         filled=tk.filled[rows])


class _PlaneBase(_TrackerMixin, _TelemetryMixin):
    """What both plane kinds share: device, engine, ring, PRNG lane."""

    def _init_plane(self, queue_capacity: int, seed: int, device,
                    engine: str) -> None:
        ops._check_engine(engine)
        self.device = resolve_device(device)
        self.engine = engine
        self.ring = _DeviceRing(queue_capacity, self.device, engine)
        self.rng = _RngLane(seed)
        self.names: list[str] = []

    @property
    def queue_capacity(self) -> int:
        return self.ring.capacity

    def pending(self) -> int:
        return int(self.ring.fill.sum())

    def queue_free(self, row: int) -> int:
        return self.ring.free(row)

    def queue_append_rows(self, rows, batches) -> None:
        self.ring.append(rows, batches)

    def _rows_d(self, rows) -> torch.Tensor:
        """Host row indices as an int64 tensor on the plane's device,
        uploaded without a synchronize (`core/staging.py`)."""
        return staging.upload(self.device, np.asarray(rows, np.int64))[0]


class TenantPlane(_PlaneBase):
    """Tenants sharing one SketchSpec: stacked (T, d, w) tables + ring."""

    def __init__(self, spec: SketchSpec, queue_capacity: int, seed: int = 0,
                 track_top: Optional[int] = None,
                 metrics: Optional[obs.MetricsRegistry] = None,
                 tracer: Optional[obs.Tracer] = None, label: str = "p0",
                 device=None, engine: str = "auto"):
        self._init_plane(queue_capacity, seed, device, engine)
        self.spec = spec
        self.tables = zeros((0, spec.depth, spec.storage_width),
                            spec.storage_dtype, self.device)
        self._init_tracker(track_top, self.device)
        self._init_telemetry(metrics, tracer, label)

    def add(self, name: str) -> int:
        self.names.append(name)
        self._grow_tracker(self.device)
        self._g_tenants.set(len(self.names))
        zero = zeros((1, self.spec.depth, self.spec.storage_width),
                     self.spec.storage_dtype, self.device)
        self.tables = torch.cat([signed_view(self.tables),
                                 signed_view(zero)]).view(self.tables.dtype)
        return self.ring.add_row()

    def flush(self, dense: bool = False) -> int:
        """Land every tenant's pending events.

        Tracked: per fill class, ONE fused update + score dispatch, then
        the tracker re-select.  Untracked: ONE `update_many` when every
        tenant is active in one fill class, else one `update_rows` per
        class.  The host fill mirror names the R rows with pending fill;
        rows are grouped by their own CHUNK-rounded fill
        (`tiering.fill_classes`), and every class shares this flush's
        uniforms key, so the tables land exactly as a dense whole-plane
        flush would.  `dense=True` runs that whole-plane baseline (one
        `update_many`, then with tracking a separate `query_many`
        refresh): the parity oracle.
        """
        pending = self.pending()
        if pending == 0:
            return 0
        rng = self.rng.next()
        active = np.flatnonzero(self.ring.fill).astype(np.int32)
        tr = self.tracer
        with tr.span("flush_epoch", plane=self.label,
                     rows=int(active.size)) as ep:
            classes = tiering.fill_classes(self.ring.fill, active,
                                           self.ring.queue.shape[1])
            if dense or (self.tracker is None and len(classes) == 1
                         and active.size == len(self.names)):
                keys, weights = self.ring.live_slice()
                self.tables = ops.update_many(self.tables, self.spec, keys,
                                              rng, weights=weights,
                                              engine=self.engine)
                if self.tracker is not None:
                    sel = self._rows_d(active)
                    self._refresh_topk(active, keys[sel], weights[sel])
            elif self.tracker is not None:
                for cols, rows_g in classes:
                    self._flush_class_tracked(rng, cols, rows_g)
            else:
                for cols, rows_g in classes:
                    with tr.span("queue_gather", plane=self.label) as sp:
                        keys, weights = sp.sync(
                            self.ring.class_slice(rows_g, cols))
                    with tr.span("update_rows", plane=self.label) as sp:
                        self.tables = sp.sync(ops.update_rows(
                            self.tables, self.spec, keys, rng, rows_g,
                            weights=weights, engine=self.engine))
            self.ring.reset()
            ep.sync(self.tables)
        self._note_flush(pending)
        return pending

    def _flush_class_tracked(self, rng, cols: int, rows_g: np.ndarray
                             ) -> None:
        tr = self.tracer
        with tr.span("queue_gather", plane=self.label) as sp:
            keys, weights = sp.sync(self.ring.class_slice(rows_g, cols))
        rows_d = self._rows_d(rows_g)
        cand, valid = topk.candidates(self._tracker_rows(rows_d), keys,
                                      weights > 0)
        with tr.span("update_score_rows", plane=self.label) as sp:
            self.tables, est = ops.update_score_rows(
                self.tables, self.spec, keys, rng, rows_g, cand,
                weights=weights, engine=self.engine)
            sp.sync((self.tables, est))
        with tr.span("tracker_reselect", plane=self.label) as sp:
            self._scatter_tracker(rows_d, topk.reselect(cand, valid, est,
                                                        self.track_top))
            sp.sync(self.tracker.keys)

    def _refresh_topk(self, rows, keys, weights) -> None:
        """Two-launch tracker refresh (the dense baseline): candidates
        scored by a separate fused query over the gathered tables."""
        rows_d = self._rows_d(rows)
        tables = signed_view(self.tables)[rows_d].view(self.tables.dtype)
        new = topk.refresh_stacked(
            self._tracker_rows(rows_d), keys, weights > 0,
            lambda ck: ops.query_many(tables, self.spec, ck,
                                      engine=self.engine))
        self._scatter_tracker(rows_d, new)

    def topk_row(self, row: int):
        """(keys, estimates, filled) of one tenant's heap as numpy arrays,
        estimate-sorted; the stored estimates are the current answers."""
        tk = self.tracker
        return (to_numpy(tk.keys[row]), tk.estimates[row].cpu().numpy(),
                tk.filled[row].cpu().numpy())

    def query_rows(self, keys) -> torch.Tensor:
        """(T, N) estimates, tenant-ordered: ONE fused dispatch."""
        return ops.query_many(self.tables, self.spec, keys,
                              engine=self.engine)

    def table_row(self, row: int) -> torch.Tensor:
        return self.tables[row]


class WindowPlane(_PlaneBase):
    """Watermark-windowed tenants sharing one WindowSpec, stored as ONE
    (T, B, d, w) device leaf plus host cursor and watermark mirrors.

    A flush lands the R pending tenants' events in their active buckets
    through the row-mapped update on the flat (T*B, d, w) view of the
    leaf (flat row tenant*B + cursor), in place: no restack, and the
    other tenants' and buckets' cells stay.  The tracker refresh reads
    the leaf through the row-mapped stacked window query, and watermark
    rotation clears every crossing tenant's expired buckets in ONE masked
    op.  Crossing an interval boundary with buffered events flushes them
    into their own interval's bucket first.
    """

    def __init__(self, wspec: w.WindowSpec, queue_capacity: int,
                 seed: int = 0, track_top: Optional[int] = None,
                 metrics: Optional[obs.MetricsRegistry] = None,
                 tracer: Optional[obs.Tracer] = None, label: str = "w0",
                 device=None, engine: str = "auto"):
        self._init_plane(queue_capacity, seed, device, engine)
        self.wspec = wspec
        s = wspec.sketch
        self.tables = zeros((0, wspec.buckets, s.depth, s.storage_width),
                            s.storage_dtype, self.device)
        self.cursors = np.zeros((0,), np.int32)
        self._wts_key: Optional[bytes] = None  # cursors of `_wts`
        self._wts: Optional[torch.Tensor] = None
        self.epochs: list[Optional[int]] = []
        self._init_tracker(track_top, self.device)
        self._init_telemetry(metrics, tracer, label)
        self._m_rotations = self.metrics.counter("plane_rotations",
                                                 plane=label)
        self._m_rotation_dispatches = self.metrics.counter(
            "rotation_dispatches", plane=label)
        self._g_leaf_bytes = self.metrics.gauge("window_leaf_bytes",
                                                plane=label)
        self._g_epoch: list = []
        self._g_lag: list = []

    @property
    def spec(self) -> SketchSpec:
        return self.wspec.sketch

    def win_view(self, row: int) -> w.WindowedSketch:
        """One tenant's ring as a `WindowedSketch` view of the leaf."""
        return w.WindowedSketch(tables=self.tables[row],
                                cursor=int(self.cursors[row]),
                                spec=self.wspec, epoch=self.epochs[row])

    @property
    def wins(self) -> list:
        return [self.win_view(r) for r in range(len(self.names))]

    def add(self, name: str) -> int:
        s = self.spec
        self.cursors = np.concatenate(
            [self.cursors, np.zeros((1,), np.int32)])
        self.names.append(name)
        self.epochs.append(None)
        self._grow_tracker(self.device)
        self._g_tenants.set(len(self.names))
        self._g_epoch.append(self.metrics.gauge("watermark_epoch",
                                                plane=self.label, tenant=name))
        self._g_lag.append(self.metrics.gauge("watermark_lag",
                                              plane=self.label, tenant=name))
        zero = zeros((1, self.wspec.buckets, s.depth, s.storage_width),
                     s.storage_dtype, self.device)
        self.tables = torch.cat([signed_view(self.tables),
                                 signed_view(zero)]).view(self.tables.dtype)
        self._g_leaf_bytes.set(self.tables.numel()
                               * self.tables.element_size())
        return self.ring.add_row()

    def advance(self, row: int, ts, flush_cb) -> None:
        """Advance one tenant's watermark to own `ts` (see `advance_many`)."""
        self.advance_many([(row, ts)], flush_cb)

    def advance_many(self, items, flush_cb) -> None:
        """Advance tenants' watermarks to own their timestamps.

        items: [(row, ts)].  Watermarks are compared on the host mirror,
        so same-interval enqueues cost no device work.  Every boundary
        crossing of the call rotates in ONE masked zeroing
        (`ops.window_advance_rows`); if a rotating row has buffered
        events, the plane flushes ONCE first, into the pre-rotation
        buckets.  A timestamp behind its ring's watermark interval
        raises ValueError."""
        steps = np.zeros(len(self.names), np.int32)
        for row, ts in items:
            target = w.interval_epoch(self.wspec, ts)
            have = self.epochs[row]
            if have is None:
                self.epochs[row] = target
                self._g_epoch[row].set(target)
                continue
            have += int(steps[row])  # earlier items in this same call
            if target < have:
                raise ValueError(
                    f"non-monotone watermark: ts {ts} (interval {target}) "
                    f"is behind the ring's watermark interval {have}")
            self._g_lag[row].set(target - have)
            steps[row] += target - have
        rot = np.flatnonzero(steps).astype(np.int32)
        if rot.size == 0:
            return
        if self.ring.fill[rot].any():
            flush_cb()
        with self.tracer.span("window_rotate", plane=self.label,
                              rows=int(rot.size)) as sp:
            self.tables = sp.sync(ops.window_advance_rows(
                self.tables, self.cursors, steps))
        self._m_rotation_dispatches.inc()
        self.cursors = ((self.cursors + steps) % self.wspec.buckets).astype(
            np.int32)
        for row in rot:
            self.epochs[row] += int(steps[row])
            self._g_epoch[row].set(self.epochs[row])
        self._m_rotations.inc(int(steps.sum()))

    def flush(self, dense: bool = False) -> int:
        """Land every pending tenant's events in its ACTIVE bucket, on the
        leaf in place: per fill class ONE `update_rows` on the flat
        (T*B, d, w) view at rows tenant*B + cursor, uniforms drawn over
        the (T, N) tenant grid; then (tracking on) ONE row-mapped
        `window_query_stacked` tracker refresh.  `dense=True` runs the
        reference's restack baseline instead: gather every tenant's active
        bucket, one `update_many`, scatter back (the parity oracle)."""
        pending = self.pending()
        if pending == 0:
            return 0
        rng = self.rng.next()
        t = len(self.names)
        b = self.wspec.buckets
        rows = (np.arange(t, dtype=np.int32) if dense
                else np.flatnonzero(self.ring.fill).astype(np.int32))
        tr = self.tracer
        with tr.span("flush_epoch", plane=self.label,
                     rows=int(rows.size)) as ep:
            kw = None
            if dense:
                with tr.span("queue_gather", plane=self.label) as sp:
                    keys, weights = sp.sync(self.ring.live_slice())
                ti = self._rows_d(rows)
                bi = self._rows_d(self.cursors[rows])
                leaf = signed_view(self.tables)
                stack = leaf[ti, bi].view(self.tables.dtype)
                stack = ops.update_many(stack, self.spec, keys, rng,
                                        weights=weights,
                                        uniform_rows=(t, rows),
                                        engine=self.engine)
                leaf[ti, bi] = signed_view(stack)
                kw = (keys, weights)
            else:
                classes = tiering.fill_classes(self.ring.fill, rows,
                                               self.ring.queue.shape[1])
                flat = self.tables.view((t * b,) + self.tables.shape[2:])
                for cols, rows_g in classes:
                    with tr.span("queue_gather", plane=self.label) as sp:
                        keys, weights = sp.sync(
                            self.ring.class_slice(rows_g, cols))
                    flat_rows = rows_g.astype(np.int64) * b \
                        + self.cursors[rows_g]
                    with tr.span("window_update", plane=self.label) as sp:
                        sp.sync(ops.update_rows(
                            flat, self.spec, keys, rng, flat_rows,
                            weights=weights, uniform_rows=(t, rows_g),
                            engine=self.engine))
                    if len(classes) == 1:
                        kw = (keys, weights)
            if self.tracker is not None:
                if kw is None:
                    # several fill classes: one batch-max re-gather for
                    # the refresh (stale padding is weight 0)
                    with tr.span("queue_gather", plane=self.label) as sp:
                        kw = sp.sync(self.ring.live_slice(rows))
                with tr.span("tracker_refresh", plane=self.label) as sp:
                    self._refresh_topk(rows, *kw)
                    sp.sync(self.tracker.keys)
            self.ring.reset()
            ep.sync(self.tables)
        self._note_flush(pending)
        return pending

    def _refresh_topk(self, rows, keys, weights) -> None:
        """Heap refresh of the flushed tenants: candidates scored by ONE
        row-mapped stacked window query on the leaf, each ring with its
        own weight row."""
        rows_d = self._rows_d(rows)
        wts = w.window_weights_stacked(self.cursors[rows], self.wspec.buckets,
                                       device=self.device)
        new = topk.refresh_stacked(
            self._tracker_rows(rows_d), keys, weights > 0,
            lambda ck: ops.window_query_stacked(
                self.tables, self.spec, ck, wts, rows=rows,
                engine=self.engine))
        self._scatter_tracker(rows_d, new)

    def rescore_inputs(self, row: int, n_buckets: Optional[int] = None,
                       gamma: Optional[float] = None) -> tuple:
        """The host inputs of `rescore_row`: the row as a (1,) int64 array
        and its (1, B) bucket weights under n_buckets / gamma."""
        rows = np.asarray([row], np.int64)
        return rows, w.window_weights_host(
            self.cursors[rows], self.wspec.buckets, n_buckets=n_buckets,
            gamma=gamma)

    def rescore_row(self, row: int, rows_d: torch.Tensor,
                    wts_d: torch.Tensor, mode: str = "sum",
                    engine: Optional[str] = None) -> None:
        """Re-score one tenant's standing candidates against the current
        ring (rotation, expiry and `gamma` move window estimates without
        a flush) and keep the re-ordered heap: ONE row-mapped stacked
        window query, all on the device.  `rows_d` / `wts_d` are
        `rescore_inputs` on the device."""
        empty = torch.zeros((1, 0), dtype=torch.int32,
                            device=self.device).view(torch.uint32)
        new = topk.refresh_stacked(
            self._tracker_rows(rows_d), empty, None,
            lambda ck: ops.window_query_stacked(
                self.tables, self.spec, ck, wts_d, mode=mode,
                engine=engine or self.engine, rows=[row]))
        self._scatter_tracker(rows_d, new)

    def topk_row(self, row: int, n_buckets: Optional[int] = None,
                 mode: str = "sum", gamma: Optional[float] = None,
                 engine: Optional[str] = None):
        """(keys, estimates, filled) of one tenant's heap as numpy arrays,
        re-scored first (`rescore_row`) with n_buckets / mode / gamma."""
        rows_d, wts_d = staging.upload(
            self.device, *self.rescore_inputs(row, n_buckets, gamma))
        self.rescore_row(row, rows_d, wts_d, mode, engine)
        tk = self.tracker
        return (to_numpy(tk.keys[row]), tk.estimates[row].cpu().numpy(),
                tk.filled[row].cpu().numpy())

    def full_weights(self) -> torch.Tensor:
        """(T, B) full-window weights of every ring, on the device:
        computed once (`window_weights_stacked`) and kept until a cursor
        moves (the cache is keyed by the cursors)."""
        key = self.cursors.tobytes()
        if key != self._wts_key:
            self._wts = w.window_weights_stacked(
                self.cursors, self.wspec.buckets, device=self.device)
            self._wts_key = key
        return self._wts

    def query_row(self, row: int, keys, engine: Optional[str] = None,
                  n_buckets: Optional[int] = None, mode: str = "sum",
                  gamma: Optional[float] = None) -> torch.Tensor:
        """Window estimate for one tenant: ONE one-ring window query.  The
        full window's weights are `full_weights`' row; with n_buckets or
        gamma, `window_weights_stacked` computes them for this ring."""
        if n_buckets is None and gamma is None:
            wts = self.full_weights()[row]
        else:
            wts = w.window_weights_stacked(
                self.cursors[row:row + 1], self.wspec.buckets, n_buckets,
                gamma, device=self.device)[0]
        return ops.window_query_tables(self.tables[row], self.spec, keys, wts,
                                       mode=mode,
                                       engine=engine or self.engine)

    def query_rows(self, keys) -> torch.Tensor:
        """(T, N) window estimates, tenant-ordered: ONE stacked launch over
        the whole leaf, each ring at its full-window sum (keys (N,) are
        shared by every tenant and read with ring stride 0, or (T, N) per
        tenant)."""
        return ops.window_query_stacked(self.tables, self.spec, keys,
                                        self.full_weights(),
                                        engine=self.engine)

    def table_row(self, row: int) -> torch.Tensor:
        """One tenant's ACTIVE bucket table."""
        return self.tables[row, int(self.cursors[row])]


def _rescore_for_admit(plane: "WindowPlane", row: int, ids, n_buckets=None,
                       mode: str = "sum", gamma=None, engine=None):
    """A windowed `admit`'s heap re-score.  Validated host ids go up in
    the re-score's one staged copy; returns the ids on the device."""
    host = plane.rescore_inputs(row, n_buckets, gamma)
    if not isinstance(ids, torch.Tensor):
        host += (ids.view(np.int32),)
    rows_d, wts_d, *up = staging.upload(plane.device, *host)
    plane.rescore_row(row, rows_d, wts_d, mode, engine)
    return up[0].view(torch.uint32) if up else ids


class CountService:
    """Registry of named sketches bucketed into fused-ingest planes."""

    def __init__(self, spec: Optional[SketchSpec] = None,
                 tenants: Sequence[str] = (), queue_capacity: int = 4096,
                 seed: int = 0, track_top: Optional[int] = None,
                 metrics: Optional[obs.MetricsRegistry] = None,
                 tracer: Optional[obs.Tracer] = None,
                 probe=None, tier=None, device=None, engine: str = "auto"):
        self.device = resolve_device(device)
        if queue_capacity < 1:
            raise ValueError("queue_capacity must be positive")
        if track_top is not None and track_top < 1:
            raise ValueError("track_top must be positive")
        if probe is not None:
            raise _later("probe")
        if tier is not None:
            raise _later("tier")
        ops._check_engine(engine)
        self.engine = engine
        self.default_spec = spec
        self.queue_capacity = int(queue_capacity)
        self.seed = int(seed)
        self.track_top = None if track_top is None else int(track_top)
        self._planes: dict[SketchSpec, TenantPlane] = {}
        self._wplanes: dict[w.WindowSpec, WindowPlane] = {}
        self._where: dict[str, tuple[object, int]] = {}
        self._order: list[str] = []
        self._plane_rows: dict = {}  # plane -> its rows of `_order`
        self._admission: dict[str, adm.AdmissionSpec] = {}
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self.tracer = tracer if tracer is not None else obs.Tracer()
        self._m_events = self.metrics.counter("events")
        self._m_flushes = self.metrics.counter("flushes")
        self._audit_depth = 0
        for name in tenants:
            self.add_tenant(name)

    # ---- registry ----

    @property
    def stats(self) -> dict:
        """{events, flushes}, served by the metrics registry."""
        return {"events": int(self._m_events.value),
                "flushes": int(self._m_flushes.value)}

    @stats.setter
    def stats(self, d: dict) -> None:
        self._m_events.value = int(d.get("events", 0))
        self._m_flushes.value = int(d.get("flushes", 0))

    @contextlib.contextmanager
    def _audited(self):
        """Scope one public call's dispatches into the registry's per-op
        `dispatch{op=...}` counters (re-entrant calls fold into the
        outermost scope)."""
        if self._audit_depth:
            yield
            return
        self._audit_depth += 1
        try:
            with ops.audit_scope() as tally:
                yield
        finally:
            self._audit_depth -= 1
            for op, n in tally.items():
                self.metrics.counter("dispatch", op=op).inc(n)

    @property
    def spec(self) -> Optional[SketchSpec]:
        return self.default_spec

    @property
    def tenants(self) -> list[str]:
        return list(self._order)

    @property
    def planes(self) -> list:
        """All planes, sketch planes first."""
        return list(self._planes.values()) + list(self._wplanes.values())

    def add_tenant(self, name: str, spec: Optional[SketchSpec] = None,
                   window: Optional[w.WindowSpec] = None,
                   admission: Optional[adm.AdmissionSpec] = None) -> int:
        """Register a tenant; returns its row in its plane's table stack.

        window: register a watermark-windowed tenant (its ring lives in
        the plane of its WindowSpec; `enqueue(..., ts=...)` drives
        rotation).  admission: arm the tracker-fed admission plane for
        this tenant (`admit`); needs the service's `track_top`."""
        if name in self._where:
            raise ValueError(f"tenant {name!r} already registered")
        if admission is not None and self.track_top is None:
            raise ValueError("tracker-fed admission needs the heavy-hitter "
                             "plane: construct the service with track_top=K")
        kw = dict(metrics=self.metrics, tracer=self.tracer,
                  device=self.device, engine=self.engine)
        if window is not None:
            if spec is not None and spec != window.sketch:
                raise ValueError("pass the sketch spec inside WindowSpec "
                                 "for windowed tenants")
            plane = self._wplanes.get(window)
            if plane is None:
                plane = self._wplanes.setdefault(window, WindowPlane(
                    window, self.queue_capacity, self.seed,
                    track_top=self.track_top,
                    label=f"w{len(self._wplanes)}", **kw))
        else:
            spec = spec or self.default_spec
            if spec is None:
                raise ValueError("no spec: pass one (or a WindowSpec), or "
                                 "construct the service with a default")
            plane = self._planes.get(spec)
            if plane is None:
                plane = self._planes.setdefault(spec, TenantPlane(
                    spec, self.queue_capacity, self.seed,
                    track_top=self.track_top,
                    label=f"p{len(self._planes)}", **kw))
        row = plane.add(name)
        self._where[name] = (plane, row)
        self._order.append(name)
        self._plane_rows.clear()
        if admission is not None:
            self._admission[name] = admission
        return row

    def admission_of(self, name: str) -> Optional[adm.AdmissionSpec]:
        """The tenant's admission policy (None when admission is off)."""
        self._lookup(name)
        return self._admission.get(name)

    def _lookup(self, name: str) -> tuple:
        if name not in self._where:
            raise KeyError(f"unknown tenant {name!r}; have {self.tenants}")
        return self._where[name]

    def spec_of(self, name: str) -> SketchSpec:
        plane, _ = self._lookup(name)
        return plane.spec

    def epoch_of(self, name: str) -> Optional[int]:
        """Watermark interval of a windowed tenant (None until its first
        timestamped enqueue)."""
        plane, row = self._lookup(name)
        if not isinstance(plane, WindowPlane):
            raise ValueError(f"tenant {name!r} is not windowed")
        return plane.epochs[row]

    def sketch_of(self, name: str) -> Sketch:
        """Flushed view of one tenant's sketch (shares the table slice);
        for a windowed tenant, its ACTIVE bucket's."""
        plane, row = self._lookup(name)
        self._flush_plane(plane)
        return Sketch(table=plane.table_row(row), spec=plane.spec)

    # ---- ingest ----

    def enqueue(self, name: str, keys, ts=None) -> None:
        """Buffer events for a tenant in its plane's device ring;
        auto-flushes the OWNING plane on queue pressure.  `ts` (event
        time, windowed tenants only) advances the tenant's watermark
        first, flushing its plane when the batch crosses into a new
        interval."""
        plane, row = self._lookup(name)
        keys = _as_keys(keys)
        with self._audited(), self.tracer.span("enqueue", tenant=name) as sp:
            if ts is not None:
                self._window_plane(name, plane).advance(
                    row, ts, lambda: self._flush_plane(plane))
            self._m_events.inc(int(keys.size))
            cap = plane.queue_capacity
            while keys.size:
                free = plane.queue_free(row)
                if free == 0:
                    self._flush_plane(plane)
                    free = cap
                take = min(free, keys.size)
                plane.queue_append_rows([row], [keys[:take]])
                keys = keys[take:]
            plane.note_append()
            sp.sync(plane.ring.queue)

    def enqueue_many(self, events: dict, ts=None) -> None:
        """Buffer several tenants' microbatches with ONE append launch per
        plane; a batch that does not fit its tenant's free space in one
        piece goes through `enqueue` (whose pressure flush is scoped to
        the owning plane).  `ts` advances every listed tenant's watermark
        as in `enqueue` (all of them must be windowed): one masked
        rotation per plane."""
        by_plane: dict[int, tuple[object, list, list]] = {}
        overflow: list[tuple[str, np.ndarray]] = []
        with self._audited(), \
                self.tracer.span("enqueue_many", tenants=len(events)) as sp:
            if ts is not None:
                adv: dict[int, tuple[WindowPlane, list]] = {}
                for name in events:
                    plane, row = self._lookup(name)
                    plane = self._window_plane(name, plane)
                    adv.setdefault(id(plane), (plane, []))[1].append(
                        (row, ts))
                for plane, items in adv.values():
                    plane.advance_many(
                        items, lambda p=plane: self._flush_plane(p))
            for name, keys in events.items():
                plane, row = self._lookup(name)
                keys = _as_keys(keys)
                if keys.size == 0:
                    continue
                if keys.size > plane.queue_free(row):
                    overflow.append((name, keys))
                    continue
                _, rows, batches = by_plane.setdefault(id(plane),
                                                       (plane, [], []))
                rows.append(row)
                batches.append(keys)
                self._m_events.inc(int(keys.size))
            for plane, rows, batches in by_plane.values():
                plane.queue_append_rows(rows, batches)
                plane.note_append()
            sp.sync([plane.ring.queue for plane, _, _ in by_plane.values()])
        for name, keys in overflow:
            self.enqueue(name, keys)

    def flush(self) -> int:
        """Land every DIRTY plane's pending events (clean planes cost no
        dispatch and no PRNG draw).  Returns the events ingested."""
        with self._audited():
            total = sum(plane.flush() for plane in self.dirty_planes)
        if total:
            self._m_flushes.inc()
        return total

    def _flush_plane(self, plane) -> int:
        """Scoped flush epoch: land ONE plane's pending events."""
        with self._audited():
            total = plane.flush() if plane.pending() else 0
        if total:
            self._m_flushes.inc()
        return total

    @staticmethod
    def _window_plane(name: str, plane):
        if not isinstance(plane, WindowPlane):
            raise ValueError(f"tenant {name!r} is not windowed; register "
                             "with a WindowSpec to use ts")
        return plane

    @property
    def dirty_planes(self) -> list:
        """Planes with buffered events (the host fill mirror says so)."""
        return [p for p in self.planes if p.pending()]

    # ---- serving ----

    def query(self, name: str, keys, **window_kw) -> torch.Tensor:
        """Estimated counts for one tenant (flushes its own plane first).

        Plain tenants: one fused dispatch, the T = 1 case of `query_all`'s
        kernel.  Windowed tenants: one window query over the ring
        (`window_kw`: n_buckets / mode / gamma / engine)."""
        plane, row = self._lookup(name)
        with self._audited(), self.tracer.span("query", tenant=name) as sp:
            self._flush_plane(plane)
            probes = _as_keys(keys)
            if isinstance(plane, WindowPlane):
                return sp.sync(plane.query_row(row, probes, **window_kw))
            if window_kw:
                raise ValueError(f"tenant {name!r} is not windowed; window "
                                 f"args {sorted(window_kw)} do not apply")
            return sp.sync(ops.query(Sketch(table=plane.table_row(row),
                                            spec=plane.spec), probes,
                                     engine=self.engine))

    def query_all(self, keys) -> dict[str, torch.Tensor]:
        """Estimated counts for EVERY tenant: one fused dispatch per plane
        (a window plane answers all its tenants in ONE stacked window
        query).

        keys: (N,) probes shared by all tenants, or (T, N) per-tenant
        probes in registry order (`self.tenants`).  Returns {tenant:
        float32 (N,) estimates}.  Flushes every dirty plane first.
        """
        with self._audited(), \
                self.tracer.span("query_all", tenants=len(self._order)) as sp:
            self.flush()
            keys = np.asarray(keys)
            per_tenant = keys.ndim == 2
            if per_tenant and keys.shape[0] != len(self._order):
                raise ValueError(f"per-tenant probes need {len(self._order)} "
                                 f"rows, got {keys.shape[0]}")
            # one upload for every plane, without a synchronize
            probes = ops.read_keys(_as_keys(keys).reshape(keys.shape),
                                   self.device)
            out: dict[str, torch.Tensor] = {}
            for plane in self.planes:
                est = plane.query_rows(self._rows_of(plane, probes)
                                       if per_tenant else probes)
                out.update(zip(plane.names, est.unbind(0)))
            return sp.sync(out)

    def _rows_of(self, plane, probes: torch.Tensor) -> torch.Tensor:
        """The plane's tenants' rows of registry-ordered (T, N) device
        probes: a view where they are consecutive, else one device gather
        (its row index uploaded once and kept until a tenant is added)."""
        rows = self._plane_rows.get(plane)
        if rows is None:
            pos = {name: i for i, name in enumerate(self._order)}
            idx = np.asarray([pos[n] for n in plane.names], np.int64)
            if np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size)):
                rows = slice(int(idx[0]), int(idx[0]) + idx.size)
            else:
                rows = staging.upload(self.device, idx)[0]
            self._plane_rows[plane] = rows
        if isinstance(rows, slice):
            return probes[rows]
        return signed_view(probes)[rows].view(torch.uint32)

    def topk(self, name: str, k: Optional[int] = None, **window_kw):
        """Current top-k heavy hitters of one tenant: (keys, estimates)
        numpy arrays, descending estimate, from the tracker (flushes the
        tenant's own plane first).  Windowed tenants re-score their
        candidates against the current ring first, with `window_kw`
        (n_buckets / mode / gamma)."""
        plane, row = self._lookup(name)
        if plane.tracker is None:
            raise ValueError("heavy-hitter tracking is off: construct the "
                             "service with track_top=K")
        k = self.track_top if k is None else int(k)
        if not 1 <= k <= self.track_top:
            raise ValueError(f"k must be in [1, {self.track_top}], got {k}")
        if window_kw and not isinstance(plane, WindowPlane):
            raise ValueError(f"tenant {name!r} is not windowed; "
                             f"window args {sorted(window_kw)} do not apply")
        with self._audited(), self.tracer.span("topk", tenant=name):
            self._flush_plane(plane)
            keys, est, filled = plane.topk_row(row, **window_kw)
        sel = filled[:k]
        return keys[:k][sel], est[:k][sel]

    def admit(self, name: str, ids, **window_kw):
        """Map raw ids -> embedding rows under the tenant's tracker-fed
        admission policy: (rows int32, admitted bool) device tensors,
        aligned with the flattened ids.

        Flushes the tenant's own plane first, so the decisions reflect
        the current flush epoch's tracker.  A plain tenant decides with
        no kernel launch (`admission.admit_tracked`: an (N, K) compare
        against the standing heap); a windowed tenant first re-scores
        its heap against the current ring (`WindowPlane.rescore_row`,
        one stacked window-query launch) with `window_kw` (n_buckets /
        mode / gamma), so an id whose traffic expired out of the window
        loses its private row.  Host ids are validated like `enqueue`'s
        keys, once, and go up in one staged copy (a windowed tenant's
        with its re-score's row and weights): on a clean plane nothing
        synchronizes.  A torch.uint32 tensor is taken as it is.
        """
        plane, row = self._lookup(name)
        aspec = self._admission.get(name)
        if aspec is None:
            raise ValueError(f"tenant {name!r} has no admission policy: "
                             "register with add_tenant(admission="
                             "AdmissionSpec(...))")
        if window_kw and not isinstance(plane, WindowPlane):
            raise ValueError(f"tenant {name!r} is not windowed; "
                             f"window args {sorted(window_kw)} do not apply")
        if isinstance(ids, torch.Tensor) and ids.dtype == torch.uint32:
            ids = ids.reshape(-1)
        else:
            ids = _as_keys(ids)
        with self._audited(), self.tracer.span("admit", tenant=name) as sp:
            self._flush_plane(plane)
            if isinstance(plane, WindowPlane):
                ids = _rescore_for_admit(plane, row, ids, **window_kw)
            elif not isinstance(ids, torch.Tensor):
                ids = ops.read_keys(ids, plane.device)
            tk = plane.tracker
            return sp.sync(adm.admit_tracked(tk.keys[row], tk.estimates[row],
                                             tk.filled[row], ids, aspec))

    # ---- persistence ----

    def _meta(self) -> dict:
        """The manifest metadata, as the reference writes it (v8
        untiered: the plane layout, the PRNG lanes, the admission
        policies (v4), the metrics snapshot (v5) and the packed flag
        (v6))."""
        meta = {
            "version": VERSION,
            "queue_capacity": self.queue_capacity,
            "seed": self.seed,
            "track_top": self.track_top,
            "tenant_order": self.tenants,
            "stats": dict(self.stats),
            "metrics": self.metrics.snapshot(),
            "admission": {name: dataclasses.asdict(spec)
                          for name, spec in self._admission.items()},
            "planes": [{"spec": _spec_meta(p.spec), "tenants": list(p.names),
                        "rng_draws": p.rng.draws}
                       for p in self._planes.values()],
            "windows": [{"sketch": _spec_meta(p.spec),
                         "buckets": p.wspec.buckets,
                         "interval": p.wspec.interval,
                         "tenants": list(p.names), "rng_draws": p.rng.draws}
                        for p in self._wplanes.values()],
        }
        if self.default_spec is not None:
            meta["spec"] = _spec_meta(self.default_spec)  # v1 reader compat
            meta["tenants"] = self.tenants
        return meta

    def _tree(self, with_topk: Optional[bool] = None) -> dict:
        """Checkpoint leaf tree: per plane `tables` (storage layout), the
        ring `queue` and its `fill` (int32, as the reference writes it),
        with tracking `topk.{keys, estimates, filled}`; a window plane's
        `tables` is its (T, B, d, sw) leaf, beside the `cursor` and
        `epoch` (-1: no watermark yet) mirrors.  with_topk defaults to
        whether tracking is on (restore passes the manifest's answer)."""
        if with_topk is None:
            with_topk = self.track_top is not None

        def leaf(p) -> dict:
            out = {"tables": p.tables, "queue": p.ring.queue,
                   "fill": p.ring.fill.astype(np.int32)}
            if with_topk:
                tk = p.tracker
                out["topk"] = {"keys": tk.keys, "estimates": tk.estimates,
                               "filled": tk.filled}
            return out

        windows = [dict(leaf(p), cursor=np.asarray(p.cursors, np.int32),
                        epoch=np.asarray([-1 if e is None else int(e)
                                          for e in p.epochs], np.int32))
                   for p in self._wplanes.values()]
        return {"planes": [leaf(p) for p in self._planes.values()],
                "windows": windows}

    def snapshot(self, root: str, step: int) -> str:
        """Atomic checkpoint of every plane (pending ring events
        included); returns its directory."""
        return checkpoint.save(root, step, self._tree(),
                               metadata=self._meta())

    @classmethod
    def restore(cls, root: str, step: Optional[int] = None,
                track_top: Optional[int] = None,
                packed: Optional[bool] = None, device=None,
                engine: str = "auto") -> "CountService":
        """Rebuild a service (registry, planes, rings, trackers, lanes,
        admission policies, metrics) from a snapshot on `device`.

        Reads manifests v8 down to v2 (pre-v6 specs restore as
        packed=False, pre-v5 with cold metrics: only the events/flushes
        stats carry over) and the v1 single-plane layout, whose host
        queue replays into the device ring.  `packed=True/False`
        converts every plane's storage layout on load, cell for cell, so
        estimates are bit-identical.  `track_top`: a tracker-less
        snapshot comes back with cold (T, track_top) heaps; one taken at
        another width has its heaps resized (`topk.resize_stacked`:
        shrinking keeps each row's best candidates, growing appends cold
        slots).  A tiered manifest raises NotImplementedError."""
        meta, step = checkpoint.load_metadata(root, step)
        if meta.get("version", 1) < 2:
            svc = cls._restore_v1(root, step, meta, track_top, device,
                                  engine)
        else:
            svc = cls._from_meta(meta, track_top, device, engine)
            saved_k = meta.get("track_top")
            tree, _ = checkpoint.restore(
                root, svc._tree(with_topk=saved_k is not None), step=step)
            svc._load_tree(meta, tree)
            if track_top is not None and saved_k is not None \
                    and track_top != saved_k:
                svc._resize_trackers(track_top)
        if packed is not None:
            svc._convert_packing(packed)
        return svc

    @classmethod
    def _from_meta(cls, meta: dict, track_top: Optional[int], device,
                   engine: str) -> "CountService":
        """An empty service with the registry `meta` (v2+) describes: its
        planes in their saved order, the tenants with their admission
        policies; trackers at the saved width, or at `track_top` when
        the snapshot had none."""
        if "tier" in meta or any(
                "tier" in pm
                for pm in meta["planes"] + meta.get("windows", [])):
            raise _later("tier")
        default = _spec_from_meta(meta["spec"]) if "spec" in meta else None
        saved_k = meta.get("track_top")
        svc = cls(default, queue_capacity=meta["queue_capacity"],
                  seed=meta.get("seed", 0),
                  track_top=saved_k if saved_k is not None else track_top,
                  device=device, engine=engine)
        admission_of = {name: adm.AdmissionSpec(**spec)
                        for name, spec in meta.get("admission", {}).items()}
        plane_of: dict[str, dict] = {}
        for pm in meta["planes"]:
            plane_of.update({n: {"spec": _spec_from_meta(pm["spec"])}
                             for n in pm["tenants"]})
        for wm in meta.get("windows", []):
            wspec = w.WindowSpec(sketch=_spec_from_meta(wm["sketch"]),
                                 buckets=wm["buckets"],
                                 interval=wm["interval"])
            plane_of.update({n: {"window": wspec} for n in wm["tenants"]})
        for name in meta["tenant_order"]:
            svc.add_tenant(name, admission=admission_of.get(name),
                           **plane_of[name])
        return svc

    def _load_tree(self, meta: dict, tree: dict) -> None:
        """Land a restored leaf tree (tensors on this service's device,
        host mirrors as numpy) and the manifest's lanes, stats and
        metrics into the planes `_from_meta` built."""
        has_topk = meta.get("track_top") is not None
        for p, pm, leaves in zip(self._planes.values(), meta["planes"],
                                 tree["planes"]):
            self._restore_plane_leaves(p, pm, leaves, has_topk)
        for p, wm, leaves in zip(self._wplanes.values(),
                                 meta.get("windows", []),
                                 tree.get("windows", [])):
            self._restore_plane_leaves(p, wm, leaves, has_topk)
            p.cursors = np.asarray(leaves["cursor"], np.int32).copy()
            p.epochs = [None if e < 0 else int(e)
                        for e in np.asarray(leaves["epoch"]).tolist()]
        self.stats = dict(meta.get("stats", self.stats))
        if "metrics" in meta:
            self.metrics.load(meta["metrics"])

    @staticmethod
    def _restore_plane_leaves(p, pm: dict, leaves: dict,
                              has_topk: bool) -> None:
        if list(p.names) != list(pm["tenants"]):
            raise ValueError(f"plane tenant order {p.names} differs from "
                             f"the manifest's {pm['tenants']}")
        tables = leaves["tables"]
        if tables.dtype != p.tables.dtype:
            raise ValueError(f"tables leaf of dtype {tables.dtype} does not "
                             f"match the plane's storage {p.tables.dtype}")
        p.rng.draws = int(pm.get("rng_draws", 0))
        p.tables = tables
        p.ring.queue = leaves["queue"]
        p.ring.fill = np.asarray(leaves["fill"], np.int64).copy()
        if has_topk:
            p.tracker = topk.TopK(**leaves["topk"])

    def _convert_packing(self, packed: bool) -> None:
        """Switch every plane's table storage layout in place
        (repack-on-load), cell for cell: estimates are bit-identical.
        Registry keys, the default spec and the window specs follow."""
        if self.default_spec is not None:
            self.default_spec = dataclasses.replace(self.default_spec,
                                                    packed=packed)
        planes: dict[SketchSpec, TenantPlane] = {}
        for spec, p in self._planes.items():
            new = dataclasses.replace(spec, packed=packed)
            if new != spec:
                p.tables = _repack(p.tables, spec, new)
                p.spec = new
            planes[new] = p
        self._planes = planes
        wplanes: dict[w.WindowSpec, WindowPlane] = {}
        for wspec, p in self._wplanes.items():
            new_sk = dataclasses.replace(wspec.sketch, packed=packed)
            if new_sk != wspec.sketch:
                p.tables = _repack(p.tables, wspec.sketch, new_sk)
                p.wspec = dataclasses.replace(wspec, sketch=new_sk)
            wplanes[p.wspec] = p
        self._wplanes = wplanes

    def _resize_trackers(self, k: int) -> None:
        """Re-arm every plane's heap stack at width k."""
        self.track_top = int(k)
        for plane in self.planes:
            plane.track_top = self.track_top
            if plane.tracker is not None:
                plane.tracker = topk.resize_stacked(plane.tracker,
                                                    self.track_top)

    @classmethod
    def _restore_v1(cls, root: str, step: int, meta: dict,
                    track_top: Optional[int], device, engine: str
                    ) -> "CountService":
        """The pre-plane (single-spec, host-queue) layout: load the
        stacked tables, replay the saved host queue into the device ring
        (one append a tenant with events).  Trackers, if re-armed, start
        cold; the v1 split-chain PRNG leaf has no lane equivalent, so the
        plane restarts its lane."""
        spec = _spec_from_meta(meta["spec"])
        svc = cls(spec, tenants=meta["tenants"],
                  queue_capacity=meta["queue_capacity"],
                  track_top=track_top, device=device, engine=engine)
        plane = next(iter(svc._planes.values()))
        t = len(meta["tenants"])
        target = {"tables": plane.tables,
                  "queue": checkpoint.Leaf((t, meta["queue_capacity"]),
                                           np.uint32),
                  "fill": checkpoint.Leaf((t,), np.int64)}
        tree, _ = checkpoint.restore(root, target, step=step)
        plane.tables = tree["tables"]
        queue = np.asarray(tree["queue"], np.uint32)
        fill = np.asarray(tree["fill"], np.int64)
        for r in np.flatnonzero(fill):
            plane.ring.append([r], [queue[r, :fill[r]]])
        svc.stats = dict(meta.get("stats", svc.stats))
        return svc
