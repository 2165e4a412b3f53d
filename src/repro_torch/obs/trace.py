"""Span tracer for the asynchronous CUDA hot path.

Counterpart of `repro/obs/trace.py`.  CUDA launches return before the
device finishes, so a wall clock around `svc.flush()` times the enqueue
of the work, not the work.  An enabled span therefore closes at a
synchronization point: `Span.sync` waits for the device
(`torch.cuda.synchronize`) before the closing timestamp, so its duration
covers the device work it claims to cover.  That is the measurement tax
tracing opts into.

Spans on the profiler's clock: whenever a torch profiler records
(`torch.profiler.profile`, or `torch.autograd.profiler.emit_nvtx`, which
sets the same flag, so the ranges are NVTX ranges under nsys), every span,
with the tracer enabled or not, is also a "cml.<name>" range: the host
event `torch.profiler.record_function` makes, opened through its C++
context manager `_RecordFunctionFast` (about 1.5 us a range on a
recording CPU, where `record_function` costs 11 us).  The program's
phases then sit in the profiler's trace beside the device's kernels
and copies, on one clock, and a device operation belongs to the ranges
its launch was made in (the launch and the operation share a
correlation id).  Such a range synchronizes nothing.

An enabled tracer's events carry `id`, `parent` (the enclosing span's
id, None at a public call) and `root` (the outermost span's id, shared
by every span of one call) in `args`; `summary` gives each span's self
time.  Code below the service opens its spans with `span(name)`, on the
tracer of the innermost active scope (`obs/scope.py`).

The DISABLED tracer (the default everywhere) with no profiler recording
costs one flag check on the ingest hot loop: `span` returns one shared
`_NullSpan` whose `sync` is identity -- no timestamp, no allocation, no
synchronization.
"""
from __future__ import annotations

import collections
import time
from typing import Any

import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch.obs import scope

PREFIX = "cml."  # of the profiler ranges the spans open

# the C++ context manager behind `record_function` (torch 2.2 and later);
# private, so a torch without it fails here and not at a profiled span
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast",
                              None)
if _RecordFunctionFast is None:
    raise ImportError("repro_torch.obs.trace needs "
                      "torch._C._profiler._RecordFunctionFast (torch >= 2.2)")


def _recording() -> bool:
    """Whether a torch profiler (or `emit_nvtx`) records: one flag read,
    where an unguarded range costs its record either way."""
    return _autograd_profiler._is_profiler_enabled


class _NullSpan:
    """Shared no-op span: the disabled tracer's entire overhead."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def sync(self, arrays: Any) -> Any:
        return arrays


_NULL_SPAN = _NullSpan()


class _Range:
    """A span that is only a profiler range (no tracer records it)."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = _RecordFunctionFast(PREFIX + name)

    def __enter__(self) -> "_Range":
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)

    def sync(self, arrays: Any) -> Any:
        return arrays


def _untraced(name: str):
    """A span no tracer records: a profiler range while a profiler
    records, else the null span."""
    return _Range(name) if _recording() else _NULL_SPAN


def _on_cuda(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_cuda(v) for v in x)
    return False


class Span:
    """One timed region.  Duration runs from __enter__ to __exit__; call
    `sync(tensors)` on the region's outputs so the closing timestamp sits
    after the device finished them (un-synced spans still record, but
    only measure host-side launch time -- `synced` says which)."""

    __slots__ = ("tracer", "name", "meta", "t0", "synced", "id", "parent",
                 "root", "_range")

    def __init__(self, tracer: "Tracer", name: str, meta: dict):
        self.tracer = tracer
        self.name = name
        self.meta = meta
        self.t0 = 0.0
        self.synced = False

    def __enter__(self) -> "Span":
        self._range = _Range(self.name).__enter__() if _recording() else None
        tr = self.tracer
        self.id = tr._next_id
        tr._next_id += 1
        stack = tr._open
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def sync(self, arrays: Any) -> Any:
        if _on_cuda(arrays):
            torch.cuda.synchronize()
        self.synced = True
        return arrays

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.tracer._open.remove(self)
        if self._range is not None:
            self._range.__exit__(*exc)
        self.tracer._record(self, t1)


class Tracer:
    """Collects spans as chrome://tracing-ready complete events.

    `metrics` (optional `MetricsRegistry`) additionally lands every span
    duration in a per-op log2 histogram (`span_duration_us{span=...}`,
    1 us .. ~16.8 s bounds)."""

    def __init__(self, enabled: bool = False, metrics=None):
        self.enabled = bool(enabled)
        self.metrics = metrics
        self.events: list[dict] = []
        self._epoch = time.perf_counter()
        self._open: list[Span] = []
        self._next_id = 0

    def span(self, name: str, **meta):
        """Context manager timing one region (while disabled, a profiler
        range when a profiler records, else a no-op)."""
        if self.enabled:
            return Span(self, name, meta)
        return _untraced(name)

    def _record(self, sp: Span, t1: float) -> None:
        args = dict(sp.meta)
        args.update(synced=sp.synced, id=sp.id, parent=sp.parent,
                    root=sp.root)
        self.events.append({
            "name": sp.name,
            "ts": (sp.t0 - self._epoch) * 1e6,   # chrome traces are in us
            "dur": (t1 - sp.t0) * 1e6,
            "args": args,
        })
        if self.metrics is not None:
            self.metrics.histogram("span_duration_us", lo=0, hi=24,
                                   span=sp.name).observe((t1 - sp.t0) * 1e6)

    def clear(self) -> None:
        self.events.clear()
        self._epoch = time.perf_counter()

    def summary(self) -> dict[str, dict]:
        """{span name: {count, total_us, max_us, self_us}}; `self_us` is
        the spans' duration less the parts of it their children cover."""
        covered: collections.Counter = collections.Counter()
        for ev in self.events:
            if ev["args"]["parent"] is not None:
                covered[ev["args"]["parent"]] += ev["dur"]
        out: dict[str, dict] = {}
        for ev in self.events:
            s = out.setdefault(ev["name"], {"count": 0, "total_us": 0.0,
                                            "max_us": 0.0, "self_us": 0.0})
            s["count"] += 1
            s["total_us"] += ev["dur"]
            s["max_us"] = max(s["max_us"], ev["dur"])
            s["self_us"] += ev["dur"] - covered[ev["args"]["id"]]
        return out


def span(name: str, **meta):
    """A span opened below the service: on the tracer of the innermost
    active scope (`obs/scope.py`); outside every scope, a profiler range
    when a profiler records, else the null span."""
    tr = scope.tracer()
    if tr is not None:
        return tr.span(name, **meta)
    return _untraced(name)
