"""Span tracer for the asynchronous CUDA hot path.

Counterpart of `repro/obs/trace.py`.  CUDA launches return before the
device finishes, so a wall clock around `svc.flush()` times the enqueue
of the work, not the work.  An enabled span therefore closes at a
synchronization point: `Span.sync` waits for the device
(`torch.cuda.synchronize`) before the closing timestamp, so its duration
covers the device work it claims to cover.  That is the measurement tax
tracing opts into.

The DISABLED tracer (the default everywhere) costs nothing on the ingest
hot loop: `Tracer(enabled=False).span(...)` returns one shared
`_NullSpan` whose `sync` is identity -- no timestamp, no allocation, no
synchronization.
"""
from __future__ import annotations

import time
from typing import Any

import torch


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

    __slots__ = ("tracer", "name", "meta", "t0", "synced")

    def __init__(self, tracer: "Tracer", name: str, meta: dict):
        self.tracer = tracer
        self.name = name
        self.meta = meta
        self.t0 = 0.0
        self.synced = False

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def sync(self, arrays: Any) -> Any:
        if _on_cuda(arrays):
            torch.cuda.synchronize()
        self.synced = True
        return arrays

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.tracer._record(self.name, self.t0, t1, self.synced, self.meta)


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

    def span(self, name: str, **meta):
        """Context manager timing one region (no-op when disabled)."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, meta)

    def _record(self, name: str, t0: float, t1: float, synced: bool,
                meta: dict) -> None:
        args = dict(meta)
        args["synced"] = synced
        self.events.append({
            "name": name,
            "ts": (t0 - self._epoch) * 1e6,   # chrome traces are in us
            "dur": (t1 - t0) * 1e6,
            "args": args,
        })
        if self.metrics is not None:
            self.metrics.histogram("span_duration_us", lo=0, hi=24,
                                   span=name).observe((t1 - t0) * 1e6)

    def clear(self) -> None:
        self.events.clear()
        self._epoch = time.perf_counter()

    def summary(self) -> dict[str, dict]:
        """{span name: {count, total_us, max_us}}."""
        out: dict[str, dict] = {}
        for ev in self.events:
            s = out.setdefault(ev["name"],
                               {"count": 0, "total_us": 0.0, "max_us": 0.0})
            s["count"] += 1
            s["total_us"] += ev["dur"]
            s["max_us"] = max(s["max_us"], ev["dur"])
        return out
