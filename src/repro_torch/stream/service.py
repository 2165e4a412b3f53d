"""Multi-tenant counting service: spec-bucketed planes + device-resident ingest.

PyTorch counterpart of `repro/stream/service.py`, for the main path:
plain (untiered, unwindowed) `TenantPlane`s with heavy-hitter tracking.

  * Tenants sharing one `SketchSpec` stack into a `TenantPlane` whose
    tables form one (T, d, w) device tensor; tenants with another spec
    land in their own plane, and `query_all` fans across planes.
  * The ingest queue is device-resident: each plane owns a (T, capw)
    uint32 ring appended in place by `ops.queue_append` (the dense kernel
    when a microbatch covers the whole plane, the row-mapped one
    otherwise).  The host keeps a deterministic fill mirror, so the ring
    never crosses back to the host.
  * A flush is one `ops.update_score_rows` per fill class: the fused
    kernel lands the chunk-sequential conservative update of the active
    rows and scores each row's candidate union (standing heap +
    just-flushed keys) in the same launch; the scores re-select the
    stacked (T, K) `TopK` tracker.
  * Each plane draws its flush uniforms from the raw threefry key
    (seed, flush#), bit-identical to the reference's draw.

Reads are read-your-writes: they flush the plane they touch first.

The port updates tables and rings in place (the reference donates them);
the results are the same.  Windows, tiering, admission, the accuracy
probe, snapshots and the untracked flush are later slices and raise
`NotImplementedError`.  Entry points run on CUDA unless `device="cpu"`;
without a GPU a CUDA service raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import sketch as sk
from repro_torch.core import topk
from repro_torch.core.counters import (from_numpy, signed_view, to_numpy,
                                       zeros)
from repro_torch.core.sketch import Sketch, SketchSpec
from repro_torch.kernels import ops
from repro_torch.stream import tiering

_as_keys = sk.as_uint32_keys

LATER = {
    "window": "windowed tenants (WindowPlane, window kernels) are slice 3",
    "tier": "hot/cold tiering is a later slice",
    "admission": "tracker-fed admission is a later slice",
    "probe": "the accuracy probe (obs/probes.py) is a later slice",
    "untracked": ("the untracked flush (track_top=None) needs "
                  "fused_update_rows/fused_update, slice 2"),
    "dense": "the dense two-launch flush baseline is slice 2",
    "snapshot": "snapshot/restore (train/checkpoint) is a later slice",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"not in this slice of the port: {LATER[what]}")


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
    """(T, capw) device ring + deterministic host fill mirror."""

    def __init__(self, capacity: int, device, engine: str):
        self.capacity = int(capacity)
        self.device = device
        self.engine = engine
        self.queue = ops.queue_init(0, capacity, device)
        self.fill = np.zeros((0,), np.int64)

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
        host staging pass, one upload, ONE append launch."""
        n = max(b.size for b in batches)
        n_pad = ops.CHUNK * -(-n // ops.CHUNK)  # CHUNK-quantized launches
        keys = np.zeros((len(rows), n_pad), np.uint32)
        count = np.empty(len(rows), np.int64)
        for i, b in enumerate(batches):
            keys[i, :b.size] = b
            count[i] = b.size
        fill = self.fill[list(rows)]
        self.queue = ops.queue_append(self.queue,
                                      from_numpy(keys, self.device),
                                      np.asarray(rows, np.int64), fill, count,
                                      engine=self.engine)
        for r, b in zip(rows, batches):
            self.fill[r] += b.size

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
    """Stacked (T, K) heavy-hitter tracker."""

    track_top: int
    tracker: topk.TopK

    def _init_tracker(self, track_top: int, device) -> None:
        self.track_top = track_top
        self.tracker = topk.init_stacked(0, track_top, device)

    def _grow_tracker(self, device) -> None:
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


class TenantPlane(_TrackerMixin, _TelemetryMixin):
    """Tenants sharing one SketchSpec: stacked (T, d, w) tables + ring."""

    def __init__(self, spec: SketchSpec, queue_capacity: int, seed: int = 0,
                 track_top: Optional[int] = None,
                 metrics: Optional[obs.MetricsRegistry] = None,
                 tracer: Optional[obs.Tracer] = None, label: str = "p0",
                 device=None, engine: str = "auto"):
        if track_top is None:
            raise _later("untracked")
        ops._check_engine(engine)
        self.device = resolve_device(device)
        self.engine = engine
        self.spec = spec
        self.tables = zeros((0, spec.depth, spec.storage_width),
                            spec.storage_dtype, self.device)
        self.ring = _DeviceRing(queue_capacity, self.device, engine)
        self.rng = _RngLane(seed)
        self.names: list[str] = []
        self._init_tracker(track_top, self.device)
        self._init_telemetry(metrics, tracer, label)

    @property
    def queue_capacity(self) -> int:
        return self.ring.capacity

    def pending(self) -> int:
        return int(self.ring.fill.sum())

    def queue_free(self, row: int) -> int:
        return self.ring.free(row)

    def queue_append_rows(self, rows, batches) -> None:
        self.ring.append(rows, batches)

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
        """Land every tenant's pending events: per fill class, ONE fused
        update + score dispatch, then the tracker re-select.

        The host fill mirror names the R rows with pending fill; rows are
        grouped by their own CHUNK-rounded fill (`tiering.fill_classes`),
        and every class shares this flush's uniforms key, so the tables
        land exactly as a dense whole-plane flush would.
        """
        if dense:
            raise _later("dense")
        pending = self.pending()
        if pending == 0:
            return 0
        rng = self.rng.next()
        active = np.flatnonzero(self.ring.fill).astype(np.int32)
        tr = self.tracer
        with tr.span("flush_epoch", plane=self.label,
                     rows=int(active.size)) as ep:
            for cols, rows_g in tiering.fill_classes(
                    self.ring.fill, active, self.ring.queue.shape[1]):
                with tr.span("queue_gather", plane=self.label) as sp:
                    keys, weights = sp.sync(
                        self.ring.class_slice(rows_g, cols))
                rows_d = torch.from_numpy(rows_g.astype(np.int64)).to(
                    self.device)
                cand, valid = topk.candidates(self._tracker_rows(rows_d),
                                              keys, weights > 0)
                with tr.span("update_score_rows", plane=self.label) as sp:
                    self.tables, est = ops.update_score_rows(
                        self.tables, self.spec, keys, rng, rows_g, cand,
                        weights=weights, engine=self.engine)
                    sp.sync((self.tables, est))
                with tr.span("tracker_reselect", plane=self.label) as sp:
                    self._scatter_tracker(
                        rows_d, topk.reselect(cand, valid, est,
                                              self.track_top))
                    sp.sync(self.tracker.keys)
            self.ring.reset()
            ep.sync(self.tables)
        self._note_flush(pending)
        return pending

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
        if track_top is None:
            raise _later("untracked")
        if track_top < 1:
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
        self.track_top = int(track_top)
        self._planes: dict[SketchSpec, TenantPlane] = {}
        self._where: dict[str, tuple[TenantPlane, int]] = {}
        self._order: list[str] = []
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
    def planes(self) -> list[TenantPlane]:
        return list(self._planes.values())

    def add_tenant(self, name: str, spec: Optional[SketchSpec] = None,
                   window=None, admission=None) -> int:
        """Register a tenant; returns its row in its plane's table stack."""
        if window is not None:
            raise _later("window")
        if admission is not None:
            raise _later("admission")
        if name in self._where:
            raise ValueError(f"tenant {name!r} already registered")
        spec = spec or self.default_spec
        if spec is None:
            raise ValueError("no spec: pass one, or construct the service "
                             "with a default")
        plane = self._planes.get(spec)
        if plane is None:
            plane = self._planes.setdefault(
                spec, TenantPlane(spec, self.queue_capacity, self.seed,
                                  track_top=self.track_top,
                                  metrics=self.metrics, tracer=self.tracer,
                                  label=f"p{len(self._planes)}",
                                  device=self.device, engine=self.engine))
        row = plane.add(name)
        self._where[name] = (plane, row)
        self._order.append(name)
        return row

    def _lookup(self, name: str) -> tuple[TenantPlane, int]:
        if name not in self._where:
            raise KeyError(f"unknown tenant {name!r}; have {self.tenants}")
        return self._where[name]

    def spec_of(self, name: str) -> SketchSpec:
        plane, _ = self._lookup(name)
        return plane.spec

    def sketch_of(self, name: str) -> Sketch:
        """Flushed view of one tenant's sketch (shares the table slice)."""
        plane, row = self._lookup(name)
        self._flush_plane(plane)
        return Sketch(table=plane.table_row(row), spec=plane.spec)

    # ---- ingest ----

    def enqueue(self, name: str, keys, ts=None) -> None:
        """Buffer events for a tenant in its plane's device ring;
        auto-flushes the OWNING plane on queue pressure."""
        if ts is not None:
            raise _later("window")
        plane, row = self._lookup(name)
        keys = _as_keys(keys)
        with self._audited(), self.tracer.span("enqueue", tenant=name) as sp:
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
        the owning plane)."""
        if ts is not None:
            raise _later("window")
        by_plane: dict[int, tuple[TenantPlane, list, list]] = {}
        overflow: list[tuple[str, np.ndarray]] = []
        with self._audited(), \
                self.tracer.span("enqueue_many", tenants=len(events)) as sp:
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

    def _flush_plane(self, plane: TenantPlane) -> int:
        """Scoped flush epoch: land ONE plane's pending events."""
        with self._audited():
            total = plane.flush() if plane.pending() else 0
        if total:
            self._m_flushes.inc()
        return total

    @property
    def dirty_planes(self) -> list[TenantPlane]:
        """Planes with buffered events (the host fill mirror says so)."""
        return [p for p in self.planes if p.pending()]

    # ---- serving ----

    def query(self, name: str, keys) -> torch.Tensor:
        """Estimated counts for one tenant (flushes its own plane first):
        one fused dispatch, the T = 1 case of `query_all`'s kernel."""
        plane, row = self._lookup(name)
        with self._audited(), self.tracer.span("query", tenant=name) as sp:
            self._flush_plane(plane)
            probes = _as_keys(keys)
            return sp.sync(ops.query(Sketch(table=plane.table_row(row),
                                            spec=plane.spec), probes,
                                     engine=self.engine))

    def query_all(self, keys) -> dict[str, torch.Tensor]:
        """Estimated counts for EVERY tenant: one fused dispatch per plane.

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
            keys = _as_keys(keys).reshape(keys.shape)
            out: dict[str, torch.Tensor] = {}
            row_of = {name: i for i, name in enumerate(self._order)}
            for plane in self.planes:
                if per_tenant:
                    probes = np.stack([keys[row_of[n]] for n in plane.names])
                else:
                    probes = keys
                est = plane.query_rows(probes)
                for i, n in enumerate(plane.names):
                    out[n] = est[i]
            return sp.sync(out)

    def topk(self, name: str, k: Optional[int] = None):
        """Current top-k heavy hitters of one tenant: (keys, estimates)
        numpy arrays, descending estimate, from the tracker (flushes the
        tenant's own plane first)."""
        plane, row = self._lookup(name)
        k = self.track_top if k is None else int(k)
        if not 1 <= k <= self.track_top:
            raise ValueError(f"k must be in [1, {self.track_top}], got {k}")
        with self._audited(), self.tracer.span("topk", tenant=name):
            self._flush_plane(plane)
            keys, est, filled = plane.topk_row(row)
        sel = filled[:k]
        return keys[:k][sel], est[:k][sel]

    def admit(self, name: str, ids):
        raise _later("admission")

    def snapshot(self, root: str, step: int) -> str:
        raise _later("snapshot")

    @classmethod
    def restore(cls, root: str, step: Optional[int] = None, **kw):
        raise _later("snapshot")
