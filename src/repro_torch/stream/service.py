"""Multi-tenant counting service: spec-bucketed planes + device-resident ingest.

PyTorch counterpart of `repro/stream/service.py`:

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
the PRNG lanes, the admission policies, the metrics and, for a tiered
service, the tier membership, the cold stores and the queue mirrors.
`restore` reads manifests v1-v8 (v1's host queue replays into the device
ring), re-packs the storage on load (`packed=`) and re-arms the trackers
at another width (`track_top=`).

Construction with `tier=TierSpec(max_hot_tenants=N, policy=...)` turns
on tiered hot/cold storage (`stream/tiering.py`): each plane keeps at
most N tenants in its device stack (slot-indexed) and the rest in a host
cold store in the storage layout.  Cold tenants' events collect in the
host queue mirror and land through one batched spill a fill class an
epoch (`ops.tier_spill`: kernels 2 and 5 on the uploaded stack, the
uniforms drawn at the tenants' rows of the full grid); promotion and
demotion ride the flush's active rows, one gather and one scatter an
epoch.  The hot-tier epoch stays one `update_score_rows` a fill class,
and `query_all` / `topk` answer as an all-resident service does, bit for
bit.  An append to hot tenants and an epoch with no cold tenant active
and no swap issue no synchronize; an append to a cold tenant launches
nothing.  A plane's cold-tier uploads and read-backs go through its own
pinned buffers (`_ColdLink`).

The port updates tables, leaves and rings in place (the reference
donates them); the results are the same.  An `AccuracyProbe`
(`probe=`) shadows the keys `enqueue` and `enqueue_many` take, on the
host, before they are appended: a probe adds no launch and no
synchronize to the append.  Entry points run on CUDA unless
`device="cpu"`; without a GPU a CUDA service raises instead of carrying
on on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import admission as adm
from repro_torch.core import sharded
from repro_torch.core import sketch as sk
from repro_torch.core import staging
from repro_torch.core import topk
from repro_torch.core.counters import (CounterSpec, numpy_dtype, signed_view,
                                       to_numpy, torch_dtype, zeros)
from repro_torch.core.device import resolve_device
from repro_torch.core.sketch import Sketch, SketchSpec
from repro_torch.kernels import ops
from repro_torch.stream import tiering
from repro_torch.stream import window as w
from repro_torch.stream.tiering import TierSpec
from repro_torch.train import checkpoint

_as_keys = sk.as_uint32_keys

VERSION = 8  # the checkpoint manifest's schema, as the reference writes it

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
        with obs.trace.span("ring_stage"):
            keys = self._stage(batches)
        with obs.trace.span("queue_append"):
            self.queue = ops.queue_append(self.queue, keys, rows,
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


class _ColdLink:
    """A tiered plane's own pinned host buffers for its cold-tier traffic,
    of a bounded size whatever the size of the cold store.

    `up` gathers rows of a host array (the cold store, the queue mirror)
    chunk by chunk, at most `SLOT_BYTES` (or one row, when a row is
    larger) at a time, into the next of two reused host slots (pinned on
    CUDA), and copies each chunk into one device tensor with a
    `non_blocking` copy (`core/staging.py`): no pageable copy, and the
    host waits only for the copy two chunks back.  `down` copies a device
    tensor back through one reused pinned buffer of the same bound, chunk
    by chunk, into rows of a host array: the design's sanctioned
    read-back (the spill's and the demotion's), which waits for each
    chunk's copy (one synchronize a chunk).  So a plane pins at most
    three such chunks (`pinned_bytes`).
    On the CPU, the same packing into plain memory."""

    SLOTS = 2
    SLOT_BYTES = 32 << 20

    def __init__(self, device):
        self.device = device
        self._cuda = device.type == "cuda"
        self._staging = staging.HostStaging(device, self.SLOTS, torch.uint8)
        self._down = torch.empty(0, dtype=torch.uint8)

    @property
    def pinned_bytes(self) -> int:
        """Host bytes the link holds pinned (0 on the CPU)."""
        if not self._cuda:
            return 0
        return sum(h.numel() for h in self._staging.host) + self._down.numel()

    @staticmethod
    def _check_rows(rows: np.ndarray, n: int) -> None:
        """Raise on a row outside [0, n): a cold tenant's slot -1 or a
        stale row would move another tenant's table."""
        if rows.size and (rows.min() < 0 or rows.max() >= n):
            raise IndexError(f"rows {rows.min()}..{rows.max()} outside the "
                             f"{n} rows of the host array")

    def _per_chunk(self, row_bytes: int) -> int:
        return max(1, self.SLOT_BYTES // max(row_bytes, 1))

    def up(self, src: np.ndarray, rows=None) -> torch.Tensor:
        """src[rows] (rows of the leading axis, all of them when None) as
        a contiguous tensor of src's dtype on the device."""
        rows = (np.arange(src.shape[0]) if rows is None
                else np.asarray(rows, np.int64).reshape(-1))
        tail = tuple(src.shape[1:])
        row_bytes = int(np.prod(tail, dtype=np.int64)) * src.dtype.itemsize
        self._check_rows(rows, src.shape[0])
        per = self._per_chunk(row_bytes)
        dev = torch.empty(rows.size * row_bytes, dtype=torch.uint8,
                          device=self.device)
        for a in range(0, rows.size, per):
            r = rows[a:a + per]
            host = self._staging.stage(r.size * row_bytes)
            # mode="clip" writes straight into `out` (the default "raise"
            # buffers the whole gather first); `_check_rows` checked rows
            np.take(src, r, axis=0, mode="clip",
                    out=host.numpy().view(src.dtype).reshape((r.size,) + tail))
            self._staging.send(host,
                               dev[a * row_bytes:(a + r.size) * row_bytes])
        return dev.view(torch_dtype(src.dtype)).view((rows.size,) + tail)

    def down(self, x: torch.Tensor, dst: np.ndarray, rows) -> None:
        """dst[rows] = x: a device tensor, rows along its leading axis,
        copied into rows of the host array dst (x's storage dtype)."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if not rows.size:
            return
        self._check_rows(rows, dst.shape[0])
        if not self._cuda:
            dst[rows] = to_numpy(x)
            return
        xb = signed_view(x).contiguous().reshape(rows.size, -1) \
            .view(torch.uint8)
        per = self._per_chunk(xb.shape[1])
        dtype, tail = numpy_dtype(x.dtype), tuple(x.shape[1:])
        for a in range(0, rows.size, per):
            chunk = xb[a:a + per]
            n = chunk.numel()
            if self._down.numel() < n:
                self._down = torch.empty(n, dtype=torch.uint8,
                                         pin_memory=True)
            host = self._down[:n]
            host.copy_(chunk.reshape(-1))
            dst[rows[a:a + per]] = host.numpy().view(dtype).reshape(
                (chunk.shape[0],) + tail)


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
    """What both plane kinds share: device, engine, ring, PRNG lane, and
    the hot/cold tier plumbing.

    With `tier=None` the tier methods are the all-resident behavior
    (device arrays indexed by tenant row, the `_DeviceRing` the only
    queue).  With a `TierSpec`, the device stacks and the ring are
    SLOT-indexed (H = min(max_hot_tenants, T) rows), `tiering.PlaneTier`
    keeps the tenant-indexed host state (cold store, queue and fill
    mirrors, recency and frequency signals), and the plane routes queue
    traffic and runs each epoch's rebalance swap.  Trackers stay
    tenant-indexed on the device for both tiers."""

    tier: Optional[tiering.PlaneTier]

    def _init_plane(self, queue_capacity: int, seed: int, device,
                    engine: str) -> None:
        ops._check_engine(engine)
        self.device = resolve_device(device)
        self.engine = engine
        self.ring = _DeviceRing(queue_capacity, self.device, engine)
        self.rng = _RngLane(seed)
        self.names: list[str] = []

    def _init_tier(self, tspec: Optional[TierSpec], row_shape) -> None:
        if tspec is None:
            self.tier = None
            return
        self.tier = tiering.PlaneTier(tspec, row_shape,
                                      numpy_dtype(self.spec.storage_dtype),
                                      self.ring.capacity)
        self._link = _ColdLink(self.device)
        m, label = self.metrics, self.label
        self._g_hot = m.gauge("tier_hot_tenants", plane=label)
        self._g_cold = m.gauge("tier_cold_tenants", plane=label)
        self._m_promotions = m.counter("tier_promotions", plane=label)
        self._m_demotions = m.counter("tier_demotions", plane=label)
        self._m_spills = m.counter("tier_spill_events", plane=label)
        self._m_spill_bytes = m.counter("tier_spill_bytes", plane=label)

    @property
    def pinned_bytes(self) -> int:
        """Host bytes pinned for the plane's cold-tier traffic (its link's
        bounded chunks; 0 untiered or on the CPU)."""
        return 0 if self.tier is None else self._link.pinned_bytes

    def _tier_gauges(self) -> None:
        if self.tier is not None:
            self._g_hot.set(self.tier.hot_count)
            self._g_cold.set(self.tier.cold_count)

    @property
    def queue_capacity(self) -> int:
        return self.ring.capacity

    def pending(self) -> int:
        if self.tier is None:
            return int(self.ring.fill.sum())
        return self.tier.pending()

    def queue_free(self, row: int) -> int:
        """Free queue slots of one tenant (a cold tenant buffers in the
        host mirror, at the device ring's capacity)."""
        if self.tier is None:
            return self.ring.free(row)
        return self.tier.free(row)

    def queue_append_rows(self, rows, batches) -> None:
        """Route tenant microbatches into the queue: hot tenants append to
        the device ring at their slots (one append launch) AND to the host
        mirror; cold tenants touch only the mirror, no device work until
        they are promoted."""
        if self.tier is None:
            self.ring.append(rows, batches)
            return
        t = self.tier
        hot = [i for i, r in enumerate(rows) if t.slot[r] >= 0]
        if hot:
            self.ring.append([int(t.slot[rows[i]]) for i in hot],
                             [batches[i] for i in hot])
        t.mirror_append(rows, batches)

    def _mirror_inputs(self, rows: np.ndarray, cols: int):
        """(keys (R, cols), (R, cols) live mask) of tenant rows from the
        host queue mirror, on the device: the keys through the plane's
        link, the mask built from one staged upload of the fills."""
        t = self.tier
        keys = self._link.up(t.hqueue[:, :cols], rows)
        return keys, ops.live_mask(t.hfill[rows], cols, self.device)

    def _note_spill(self, rows: np.ndarray) -> None:
        self._m_spills.inc(int(rows.size))
        self._m_spill_bytes.inc(2 * int(rows.size) * self.spec.memory_bytes)

    def _tier_rebalance(self) -> None:
        """Post-flush swap: the most active just-active cold tenants take
        idle victims' slots, ONE demotion gather (and its read-back, the
        sanctioned device-to-host copy) + ONE promotion scatter an epoch,
        however many tenants swap."""
        t = self.tier
        demote, promote = t.plan_swap()
        if demote.size:
            slots = t.slot[demote].copy()
            self._link.down(ops.tier_demote(self.tables, slots), t.cold,
                            demote)
            ops.tier_promote(self.tables, self.ring.queue, slots,
                             self._link.up(t.cold, promote),
                             self._link.up(t.hqueue, promote))
            t.swap(demote, promote)
            self.ring.fill[slots] = t.hfill[promote]
            self._m_promotions.inc(int(promote.size))
            self._m_demotions.inc(int(demote.size))
        self._tier_gauges()

    def stacked_tables(self) -> torch.Tensor:
        """The tenant-ordered table stack across tiers (the all-resident
        layout, `sharded.tier_assemble`); untiered, the stack itself."""
        if self.tier is None:
            return self.tables
        return sharded.tier_assemble(self.tables, self.tier.slot_tenant,
                                     self._link.up(self.tier.cold))

    def _add_slot(self, zero: torch.Tensor) -> int:
        """Register a tenant: untiered, a table row and a ring row; tiered,
        those only for a tenant that goes hot.  Returns its tenant row."""
        row = None
        if self.tier is not None:
            row, goes_hot = self.tier.add_row()
            self._tier_gauges()
            if not goes_hot:
                return row
        self.tables = torch.cat([signed_view(self.tables),
                                 signed_view(zero)]).view(self.tables.dtype)
        slot = self.ring.add_row()
        return slot if row is None else row

    def _tenant_stack(self, row: int) -> tuple:
        """(stack, i): a device stack that holds one tenant's table (a
        windowed tenant's ring) at row i.  The plane's own stack at the
        tenant's row (its slot, tiered), or a cold tenant's row uploaded
        as a one-row stack, with i None."""
        if self.tier is None:
            return self.tables, row
        slot = int(self.tier.slot[row])
        if slot >= 0:
            return self.tables, slot
        return self._link.up(self.tier.cold, [row]), None

    def _tenant_tables(self, row: int) -> torch.Tensor:
        """One tenant's table (a windowed tenant's ring) on the device:
        `_tenant_stack`'s row."""
        stack, i = self._tenant_stack(row)
        return stack[0 if i is None else i]

    def _tiered_read(self, keys, read) -> torch.Tensor:
        """(T, N) float32 answers of a tiered plane, tenant-ordered:
        read(tables, rows, probes, hot) once on the hot stack (rows: the
        hot tenants in slot order, hot True) and once on the uploaded
        cold stack, the two reassembled on the device.  keys (N,)
        shared, or (T, N) per tenant."""
        t = self.tier
        keys = ops.read_keys(keys, self.device)
        out = torch.empty((len(self.names), keys.shape[-1]),
                          dtype=torch.float32, device=self.device)
        for rows, hot in ((t.slot_tenant, True),
                          (np.flatnonzero(t.slot < 0), False)):
            if not rows.size:
                continue
            rows_d = self._rows_d(rows)
            probes = (keys if keys.dim() == 1 else
                      signed_view(keys)[rows_d].view(torch.uint32))
            tables = self.tables if hot else self._link.up(t.cold, rows)
            out.index_copy_(0, rows_d, read(tables, rows, probes, hot))
        return out

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
                 device=None, engine: str = "auto",
                 tier: Optional[TierSpec] = None):
        self._init_plane(queue_capacity, seed, device, engine)
        self.spec = spec
        self.tables = zeros((0, spec.depth, spec.storage_width),
                            spec.storage_dtype, self.device)
        self._init_tracker(track_top, self.device)
        self._init_telemetry(metrics, tracer, label)
        self._init_tier(tier, (spec.depth, spec.storage_width))

    def add(self, name: str) -> int:
        self.names.append(name)
        self._grow_tracker(self.device)
        self._g_tenants.set(len(self.names))
        return self._add_slot(zeros((1, self.spec.depth,
                                     self.spec.storage_width),
                                    self.spec.storage_dtype, self.device))

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
        refresh): the parity oracle.  A tiered plane flushes through
        `_flush_tiered` and has no dense baseline.
        """
        pending = self.pending()
        if pending == 0:
            return 0
        if self.tier is not None:
            if dense:
                raise ValueError("dense flush is the all-resident baseline "
                                 "pipeline; tiered planes have no resident "
                                 "whole-plane layout to run it on")
            return self._flush_tiered(pending)
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

    def _flush_tiered(self, pending: int) -> int:
        """Tiered flush epoch: per fill class, hot tenants land through
        the same dispatch an all-resident plane issues (rows mapped to
        their slots, uniforms drawn at their tenant rows of the full grid)
        and cold tenants through one batched spill (`_tier_spill`), so
        every table lands as in the resident service.  The epoch ends
        with the recency stamp and the rebalance swap."""
        t = self.tier
        rng = self.rng.next()
        total = len(self.names)
        active = np.flatnonzero(t.hfill).astype(np.int32)
        tr = self.tracer
        with tr.span("flush_epoch", plane=self.label,
                     rows=int(active.size)) as ep:
            for cols, rows_g in tiering.fill_classes(t.hfill, active,
                                                     t.capw):
                slot_g = t.slot[rows_g]
                hot_g = rows_g[slot_g >= 0]
                cold_g = rows_g[slot_g < 0]
                if hot_g.size:
                    self._flush_hot_class(rng, cols, hot_g, total)
                if cold_g.size:
                    with tr.span("tier_spill", plane=self.label,
                                 rows=int(cold_g.size)):
                        self._tier_spill(cold_g, cols, rng, total)
            self.ring.reset()
            t.note_flush(active)
            self._tier_rebalance()
            ep.sync(self.tables)
        self._note_flush(pending)
        return pending

    def _flush_hot_class(self, rng, cols: int, hot_g: np.ndarray,
                         total: int) -> None:
        """One fill class of hot tenants: their ring slots gathered, then
        ONE `update_score_rows` (tracked) or `update_rows` on the hot
        stack at their slots, uniforms at their tenant rows."""
        t, tr = self.tier, self.tracer
        slots = t.slot[hot_g].astype(np.int64)
        with tr.span("queue_gather", plane=self.label) as sp:
            keys, weights = sp.sync(ops.flush_rows_inputs(
                self.ring.queue, t.hfill[hot_g], slots, cols))
        if self.tracker is None:
            with tr.span("update_rows", plane=self.label) as sp:
                sp.sync(ops.update_rows(
                    self.tables, self.spec, keys, rng, slots,
                    weights=weights, uniform_rows=(total, hot_g),
                    engine=self.engine))
            return
        rows_d = self._rows_d(hot_g)
        with tr.span("tracker_candidates", plane=self.label) as sp:
            cand, valid = sp.sync(topk.candidates(self._tracker_rows(rows_d),
                                                  keys, weights > 0))
        with tr.span("update_score_rows", plane=self.label) as sp:
            _, est = ops.update_score_rows(
                self.tables, self.spec, keys, rng, slots, cand,
                weights=weights, uniform_rows=(total, hot_g),
                engine=self.engine)
            sp.sync((self.tables, est))
        self._scatter_tracker(rows_d, topk.reselect(cand, valid, est,
                                                    self.track_top))

    def _tier_spill(self, rows_g: np.ndarray, cols: int, rng, total: int
                    ) -> None:
        """Land one fill class of cold tenants from the host queue mirror
        in the cold store (buffered spill): their tables and mirror rows
        go up through the plane's link, one `ops.tier_spill` (with
        tracking, scoring the candidates too) lands them with the uniforms
        of their rows of the full grid, and the tables come back."""
        t = self.tier
        stack = self._link.up(t.cold, rows_g)
        keys, weights = self._mirror_inputs(rows_g, cols)
        if self.tracker is None:
            ops.tier_spill(stack, self.spec, keys, rng, weights,
                           (total, rows_g), engine=self.engine)
        else:
            rows_d = self._rows_d(rows_g)
            cand, valid = topk.candidates(self._tracker_rows(rows_d), keys,
                                          weights > 0)
            _, est = ops.tier_spill(stack, self.spec, keys, rng, weights,
                                    (total, rows_g), cand=cand,
                                    engine=self.engine)
            self._scatter_tracker(rows_d, topk.reselect(cand, valid, est,
                                                        self.track_top))
        self._link.down(stack, t.cold, rows_g)
        self._note_spill(rows_g)

    def _flush_class_tracked(self, rng, cols: int, rows_g: np.ndarray
                             ) -> None:
        tr = self.tracer
        with tr.span("queue_gather", plane=self.label) as sp:
            keys, weights = sp.sync(self.ring.class_slice(rows_g, cols))
        rows_d = self._rows_d(rows_g)
        with tr.span("tracker_candidates", plane=self.label) as sp:
            cand, valid = sp.sync(topk.candidates(self._tracker_rows(rows_d),
                                                  keys, weights > 0))
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
        """(T, N) estimates, tenant-ordered: ONE fused dispatch.  Tiered:
        the fused query serves the hot slots and `ops.tier_query` the
        uploaded cold stack (the same kernel), reassembled in tenant order
        on the device."""
        if self.tier is None:
            return ops.query_many(self.tables, self.spec, keys,
                                  engine=self.engine)
        return self._tiered_read(keys, lambda tables, rows, probes, hot: (
            ops.query_many if hot else ops.tier_query)(
                tables, self.spec, probes, engine=self.engine))

    def table_row(self, row: int) -> torch.Tensor:
        """One tenant's table: its slot of the hot stack, or its cold row
        uploaded."""
        return self._tenant_tables(row)


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
                 device=None, engine: str = "auto",
                 tier: Optional[TierSpec] = None):
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
        self._init_tier(tier, (wspec.buckets, s.depth, s.storage_width))

    @property
    def spec(self) -> SketchSpec:
        return self.wspec.sketch

    def ring_tables(self, row: int) -> torch.Tensor:
        """One tenant's (B, d, sw) ring on the device: a view of the leaf
        (at its slot, tiered), or a cold tenant's ring uploaded."""
        return self._tenant_tables(row)

    def win_view(self, row: int) -> w.WindowedSketch:
        """One tenant's ring as a `WindowedSketch` view of the leaf (a
        cold tenant's: its uploaded ring)."""
        return w.WindowedSketch(tables=self.ring_tables(row),
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
        row = self._add_slot(zeros((1, self.wspec.buckets, s.depth,
                                    s.storage_width), s.storage_dtype,
                                   self.device))
        self._g_leaf_bytes.set(self.tables.numel()
                               * self.tables.element_size())
        return row

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
        fill = self.ring.fill if self.tier is None else self.tier.hfill
        if fill[rot].any():
            flush_cb()
        if self.tier is None:
            self._rotate(self.cursors, steps, rot)
        else:
            # hot rings rotate on the slot-ordered leaf in one masked
            # zeroing; cold rings in the host store, the same mask
            t = self.tier
            st = t.slot_tenant
            if st.size and steps[st].any():
                self._rotate(self.cursors[st], steps[st], rot)
            for row in rot:
                if t.slot[row] < 0:
                    w.cold_advance(t.cold[row], int(self.cursors[row]),
                                   int(steps[row]))
        self.cursors = ((self.cursors + steps) % self.wspec.buckets).astype(
            np.int32)
        for row in rot:
            self.epochs[row] += int(steps[row])
            self._g_epoch[row].set(self.epochs[row])
        self._m_rotations.inc(int(steps.sum()))

    def _rotate(self, cursors, steps, rot) -> None:
        with self.tracer.span("window_rotate", plane=self.label,
                              rows=int(rot.size)) as sp:
            self.tables = sp.sync(ops.window_advance_rows(
                self.tables, cursors, steps))
        self._m_rotation_dispatches.inc()

    def flush(self, dense: bool = False) -> int:
        """Land every pending tenant's events in its ACTIVE bucket, on the
        leaf in place: per fill class ONE `update_rows` on the flat
        (T*B, d, w) view at rows tenant*B + cursor, uniforms drawn over
        the (T, N) tenant grid; then (tracking on) ONE row-mapped
        `window_query_stacked` tracker refresh.  `dense=True` runs the
        reference's restack baseline instead: gather every tenant's active
        bucket, one `update_many`, scatter back (the parity oracle).  A
        tiered plane flushes through `_flush_tiered` and has no dense
        baseline."""
        pending = self.pending()
        if pending == 0:
            return 0
        if self.tier is not None:
            if dense:
                raise ValueError("dense flush is the all-resident baseline "
                                 "pipeline; tiered planes have no resident "
                                 "whole-plane layout to run it on")
            return self._flush_tiered(pending)
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

    def _flush_tiered(self, pending: int) -> int:
        """Tiered window flush epoch: per fill class, hot tenants land in
        their ACTIVE buckets through the flat row-mapped update an
        all-resident plane issues (flat row slot * B + cursor, uniforms
        at their tenant rows of the full grid) and cold tenants spill
        their active buckets from the host mirror (`_tier_spill_window`);
        then one cross-tier tracker refresh, the recency stamp and the
        rebalance swap."""
        t_ = self.tier
        rng = self.rng.next()
        total = len(self.names)
        b = self.wspec.buckets
        active = np.flatnonzero(t_.hfill).astype(np.int32)
        tr = self.tracer
        with tr.span("flush_epoch", plane=self.label,
                     rows=int(active.size)) as ep:
            for cols, rows_g in tiering.fill_classes(t_.hfill, active,
                                                     t_.capw):
                slot_g = t_.slot[rows_g]
                hot_g = rows_g[slot_g >= 0]
                cold_g = rows_g[slot_g < 0]
                if hot_g.size:
                    slots = t_.slot[hot_g].astype(np.int64)
                    with tr.span("queue_gather", plane=self.label) as sp:
                        keys, weights = sp.sync(ops.flush_rows_inputs(
                            self.ring.queue, t_.hfill[hot_g], slots, cols))
                    h = self.tables.shape[0]
                    flat = self.tables.view((h * b,) + self.tables.shape[2:])
                    with tr.span("window_update", plane=self.label) as sp:
                        sp.sync(ops.update_rows(
                            flat, self.spec, keys, rng,
                            slots * b + self.cursors[hot_g],
                            weights=weights, uniform_rows=(total, hot_g),
                            engine=self.engine))
                if cold_g.size:
                    with tr.span("tier_spill", plane=self.label,
                                 rows=int(cold_g.size)):
                        self._tier_spill_window(cold_g, cols, rng, total)
            if self.tracker is not None:
                with tr.span("tracker_refresh", plane=self.label) as sp:
                    self._refresh_topk_tiered(active)
                    sp.sync(self.tracker.keys)
            self.ring.reset()
            t_.note_flush(active)
            self._tier_rebalance()
            ep.sync(self.tables)
        self._note_flush(pending)
        return pending

    def _cold_buckets(self) -> np.ndarray:
        """The cold store as (T * B, d, sw) bucket rows: a view, so
        writes land in the store."""
        t_ = self.tier
        flat = t_.cold.view()
        flat.shape = (-1,) + t_.row_shape[1:]  # raises rather than copy
        return flat

    def _tier_spill_window(self, rows_g: np.ndarray, cols: int, rng,
                           total: int) -> None:
        """Spill one fill class of cold windowed tenants: their ACTIVE
        buckets (flat rows tenant * B + cursor of the cold store) go up,
        land through one `ops.tier_spill` with the uniforms of their rows
        of the full grid, and come back."""
        flat = self._cold_buckets()
        rows_b = rows_g.astype(np.int64) * self.wspec.buckets \
            + self.cursors[rows_g]
        stack = self._link.up(flat, rows_b)
        keys, weights = self._mirror_inputs(rows_g, cols)
        ops.tier_spill(stack, self.spec, keys, rng, weights, (total, rows_g),
                       engine=self.engine)
        self._link.down(stack, flat, rows_b)
        self._note_spill(rows_g)

    def _refresh_topk_tiered(self, active: np.ndarray) -> None:
        """Cross-tier heap refresh: hot tenants score through the
        row-mapped stacked window query on the device leaf (kernel 9),
        cold tenants through the stacked query on their uploaded rings
        (kernel 8; both equal their plain versions, which share one
        bucket-order sum).  Each row's result is what the resident
        service's single refresh gives: the refresh is row-independent
        and both gathers run at the batch-max width."""
        t_ = self.tier
        cols = min(t_.capw,
                   ops.CHUNK * -(-int(t_.hfill[active].max()) // ops.CHUNK))
        hot = t_.slot[active] >= 0
        for rows_a, is_hot in ((active[hot], True), (active[~hot], False)):
            if rows_a.size == 0:
                continue
            rows_d = self._rows_d(rows_a)
            wts = w.window_weights_stacked(self.cursors[rows_a],
                                           self.wspec.buckets,
                                           device=self.device)
            if is_hot:
                slots = t_.slot[rows_a].astype(np.int64)
                keys, weights = ops.flush_rows_inputs(
                    self.ring.queue, t_.hfill[rows_a], slots, cols)
                tables, qrows = self.tables, slots
            else:
                keys, weights = self._mirror_inputs(rows_a, cols)
                tables, qrows = self._link.up(t_.cold, rows_a), None
            new = topk.refresh_stacked(
                self._tracker_rows(rows_d), keys, weights > 0,
                lambda ck, tb=tables, qr=qrows: ops.window_query_stacked(
                    tb, self.spec, ck, wts, rows=qr, engine=self.engine))
            self._scatter_tracker(rows_d, new)

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
        `rescore_inputs` on the device.  A cold tenant re-scores on its
        uploaded ring (the stacked query without a row map)."""
        empty = torch.zeros((1, 0), dtype=torch.int32,
                            device=self.device).view(torch.uint32)
        tables, i = self._tenant_stack(row)
        qrows = None if i is None else [i]
        new = topk.refresh_stacked(
            self._tracker_rows(rows_d), empty, None,
            lambda ck: ops.window_query_stacked(
                tables, self.spec, ck, wts_d, mode=mode,
                engine=engine or self.engine, rows=qrows))
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
        return ops.window_query_tables(self.ring_tables(row), self.spec,
                                       keys, wts, mode=mode,
                                       engine=engine or self.engine)

    def query_rows(self, keys) -> torch.Tensor:
        """(T, N) window estimates, tenant-ordered: ONE stacked launch over
        the whole leaf, each ring at its full-window sum (keys (N,) are
        shared by every tenant and read with ring stride 0, or (T, N) per
        tenant).  Tiered: one stacked query over the slot-ordered hot leaf
        and one over the uploaded cold rings (the same kernel),
        reassembled in tenant order on the device."""
        if self.tier is None:
            return ops.window_query_stacked(self.tables, self.spec, keys,
                                            self.full_weights(),
                                            engine=self.engine)
        return self._tiered_read(keys, lambda tables, rows, probes, hot: (
            ops.window_query_stacked(
                tables, self.spec, probes,
                w.window_weights_stacked(self.cursors[rows],
                                         self.wspec.buckets,
                                         device=self.device),
                engine=self.engine)))

    def table_row(self, row: int) -> torch.Tensor:
        """One tenant's ACTIVE bucket table (a cold tenant's: of its
        uploaded ring)."""
        return self.ring_tables(row)[int(self.cursors[row])]


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
                 probe: Optional[obs.AccuracyProbe] = None, tier=None,
                 device=None, engine: str = "auto"):
        self.device = resolve_device(device)
        if queue_capacity < 1:
            raise ValueError("queue_capacity must be positive")
        if track_top is not None and track_top < 1:
            raise ValueError("track_top must be positive")
        if tier is not None and not isinstance(tier, TierSpec):
            raise TypeError(f"tier must be a TierSpec, got {type(tier)}")
        ops._check_engine(engine)
        self.engine = engine
        self.default_spec = spec
        self.queue_capacity = int(queue_capacity)
        self.seed = int(seed)
        self.track_top = None if track_top is None else int(track_top)
        self.tier = tier
        # the accuracy probe (opt-in) shadows enqueued keys on the host
        self.probe = probe
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
        self._counted: dict = {}  # scope count name -> its registry Counter
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
        """Scope one public call (`obs/scope.py`): its dispatches fold
        into the registry's per-op `dispatch{op=...}` counters and its
        staging counts into theirs, and spans opened below the service
        go to the service's tracer (re-entrant calls fold into the
        outermost scope)."""
        if self._audit_depth:
            yield
            return
        self._audit_depth += 1
        audit = ops.audit_scope(self.tracer)
        try:
            with audit as tally:
                yield
        finally:
            self._audit_depth -= 1
            for op, n in tally.items():
                self.metrics.counter("dispatch", op=op).inc(n)
            for name, n in audit.scope.counts.items():
                c = self._counted.get(name)
                if c is None:
                    c = self._counted[name] = self.metrics.counter(name)
                c.inc(n)

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
                  device=self.device, engine=self.engine, tier=self.tier)
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
            if self.probe is not None:
                self.probe.observe(name, keys)
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
                if self.probe is not None:
                    self.probe.observe(name, keys)
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
        with self._audited(), self.tracer.span("flush"):
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

    def tier_occupancy(self) -> dict[str, dict[str, int]]:
        """Per-plane tier occupancy {plane label: {"hot": n, "cold": m}}
        (empty for a service built without a TierSpec)."""
        return {p.label: {"hot": p.tier.hot_count, "cold": p.tier.cold_count}
                for p in self.planes if p.tier is not None}

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
            with self.tracer.span("read_upload"):
                probes = ops.read_keys(_as_keys(keys).reshape(keys.shape),
                                       self.device)
            out: dict[str, torch.Tensor] = {}
            for plane in self.planes:
                with self.tracer.span("query_rows", plane=plane.label):
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

    @staticmethod
    def _plane_meta(p, base: dict) -> dict:
        # v8: a tiered plane's membership and policy signals (its cold
        # store is a leaf), so restore re-tiers deterministically
        if p.tier is not None:
            base["tier"] = p.tier.meta()
        return base

    def _metrics_meta(self) -> dict:
        """The registry's snapshot less the host staging's counters,
        which count this process's uploads and not the sketch's state
        (the manifest stays the reference's)."""
        snap = self.metrics.snapshot()
        for name in staging.COUNTERS:
            snap["counters"].pop(name, None)
        return snap

    def _meta(self) -> dict:
        """The manifest metadata, as the reference writes it (v8: the
        plane layout, the PRNG lanes, the admission policies (v4), the
        metrics snapshot (v5), the packed flag (v6) and a tiered
        service's TierSpec and plane memberships)."""
        meta = {
            "version": VERSION,
            "queue_capacity": self.queue_capacity,
            "seed": self.seed,
            "track_top": self.track_top,
            "tenant_order": self.tenants,
            "stats": dict(self.stats),
            "metrics": self._metrics_meta(),
            "admission": {name: dataclasses.asdict(spec)
                          for name, spec in self._admission.items()},
            "planes": [self._plane_meta(p, {"spec": _spec_meta(p.spec),
                                            "tenants": list(p.names),
                                            "rng_draws": p.rng.draws})
                       for p in self._planes.values()],
            "windows": [self._plane_meta(p, {"sketch": _spec_meta(p.spec),
                                             "buckets": p.wspec.buckets,
                                             "interval": p.wspec.interval,
                                             "tenants": list(p.names),
                                             "rng_draws": p.rng.draws})
                        for p in self._wplanes.values()],
        }
        if self.tier is not None:
            meta["tier"] = {"max_hot_tenants": self.tier.max_hot_tenants,
                            "policy": self.tier.policy}
        if self.default_spec is not None:
            meta["spec"] = _spec_meta(self.default_spec)  # v1 reader compat
            meta["tenants"] = self.tenants
        return meta

    def _tree(self, with_topk: Optional[bool] = None) -> dict:
        """Checkpoint leaf tree: per plane `tables` (storage layout), the
        ring `queue` and its `fill` (int32, as the reference writes it),
        with tracking `topk.{keys, estimates, filled}`; a window plane's
        `tables` is its (T, B, d, sw) leaf, beside the `cursor` and
        `epoch` (-1: no watermark yet) mirrors.  A tiered plane's
        `tables` is its (H, ...) hot stack, beside `cold_tables`, the
        (T, ...) host cold store, and `queue` / `fill` are the
        TENANT-indexed host mirrors (the slot-indexed device ring is
        their gather, rebuilt on restore).  with_topk defaults to whether
        tracking is on (restore passes the manifest's answer)."""
        if with_topk is None:
            with_topk = self.track_top is not None

        def leaf(p) -> dict:
            if p.tier is None:
                out = {"tables": p.tables, "queue": p.ring.queue,
                       "fill": p.ring.fill.astype(np.int32)}
            else:
                out = {"tables": p.tables, "cold_tables": p.tier.cold,
                       "queue": p.tier.hqueue,
                       "fill": p.tier.hfill.astype(np.int32)}
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
        slots).  A tiered (v8) snapshot comes back tiered, with its
        membership, cold stores and queue mirrors."""
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
        the snapshot had none; tiered (v8) when the snapshot was, its
        membership re-applied by `_load_tree`."""
        default = _spec_from_meta(meta["spec"]) if "spec" in meta else None
        saved_k = meta.get("track_top")
        tier = TierSpec(**meta["tier"]) if "tier" in meta else None
        svc = cls(default, queue_capacity=meta["queue_capacity"],
                  seed=meta.get("seed", 0),
                  track_top=saved_k if saved_k is not None else track_top,
                  device=device, engine=engine, tier=tier)
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
        if has_topk:
            p.tracker = topk.TopK(**leaves["topk"])
        if p.tier is None:
            p.ring.queue = leaves["queue"]
            p.ring.fill = np.asarray(leaves["fill"], np.int64).copy()
            return
        # tiered: the saved membership first, then the host mirrors (np
        # copies: the tier mutates them in place), then the device ring
        # rebuilt as the mirror's gather at the hot tenants
        t = p.tier
        tm = pm["tier"]
        t.load_membership(tm["slot_tenant"], tm["last_active"], tm["hits"],
                          tm["epoch"])
        t.cold = np.array(leaves["cold_tables"]).astype(t.dtype, copy=False)
        t.hqueue = np.array(leaves["queue"], np.uint32)
        t.hfill = np.array(leaves["fill"], np.int64)
        st = t.slot_tenant
        if st.size:
            p.ring.queue = p._link.up(t.hqueue, st)
        p.ring.fill = t.hfill[st].copy()
        p._tier_gauges()

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
                if p.tier is not None:
                    self._repack_cold(p, spec, new,
                                      (new.depth, new.storage_width))
            planes[new] = p
        self._planes = planes
        wplanes: dict[w.WindowSpec, WindowPlane] = {}
        for wspec, p in self._wplanes.items():
            new_sk = dataclasses.replace(wspec.sketch, packed=packed)
            if new_sk != wspec.sketch:
                p.tables = _repack(p.tables, wspec.sketch, new_sk)
                p.wspec = dataclasses.replace(wspec, sketch=new_sk)
                if p.tier is not None:
                    self._repack_cold(p, wspec.sketch, new_sk,
                                      (wspec.buckets, new_sk.depth,
                                       new_sk.storage_width))
            wplanes[p.wspec] = p
        self._wplanes = wplanes

    @staticmethod
    def _repack_cold(p, old: SketchSpec, new: SketchSpec,
                     row_shape: tuple) -> None:
        """Repack a tiered plane's cold store with its hot stack, cell for
        cell: each tenant's row goes up through the plane's link, is
        repacked on the device (`_repack`) and comes back."""
        t = p.tier
        out = np.empty((t.cold.shape[0],) + tuple(row_shape),
                       numpy_dtype(new.storage_dtype))
        for i in range(out.shape[0]):
            p._link.down(_repack(p._link.up(t.cold, [i]), old, new), out,
                         [i])
        t.cold = out
        t.row_shape = tuple(row_shape)
        t.dtype = out.dtype

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
