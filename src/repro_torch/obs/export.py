"""Exporters: Prometheus text exposition + chrome://tracing JSON.

Both consume the plain-dict forms (`MetricsRegistry.snapshot()`,
`Tracer.events`) so they serialize what a checkpoint manifest or a
cross-process merge would see -- no live objects required.  The port's
own copy of `repro/obs/export.py`: the same text and JSON for the same
snapshot and events.
"""
from __future__ import annotations

import json
import math
import re
from typing import Union

from repro_torch.obs.registry import Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer

_KEY_RE = re.compile(r"^(?P<name>[^{]+)(\{(?P<labels>.*)\})?$")


def _split_key(key: str) -> tuple[str, str]:
    """Instrument key -> (metric name, label body or '')."""
    m = _KEY_RE.match(key)
    return m.group("name"), m.group("labels") or ""


def _series(name: str, labels: str, extra: str = "") -> str:
    """Assemble `name{labels,extra}` with empty parts elided."""
    body = ",".join(x for x in (labels, extra) if x)
    return f"{name}{{{body}}}" if body else name


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def to_prometheus(metrics: Union[MetricsRegistry, dict]) -> str:
    """Prometheus text exposition (0.0.4) of a registry or its snapshot.

    Counters expose as `<name>_total`, gauges as the bare name plus
    `<name>_high_water`, histograms as cumulative `_bucket{le=...}` /
    `_sum` / `_count` -- the shapes scrape targets expect, so wiring the
    counting plane into an existing dashboard is a file away
    (`launch/serve_counts.py --metrics-out`).
    """
    snap = metrics.snapshot() if isinstance(metrics, MetricsRegistry) \
        else metrics
    lines: list[str] = []
    typed: set[str] = set()

    def header(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for key in sorted(snap.get("counters", {})):
        name, labels = _split_key(key)
        header(f"{name}_total", "counter")
        lines.append(f"{_series(f'{name}_total', labels)} "
                     f"{_fmt(snap['counters'][key])}")
    for key in sorted(snap.get("gauges", {})):
        name, labels = _split_key(key)
        g = snap["gauges"][key]
        header(name, "gauge")
        lines.append(f"{_series(name, labels)} {_fmt(g['value'])}")
        header(f"{name}_high_water", "gauge")
        lines.append(f"{_series(f'{name}_high_water', labels)} "
                     f"{_fmt(g['high_water'])}")
    for key in sorted(snap.get("histograms", {})):
        name, labels = _split_key(key)
        h = snap["histograms"][key]
        header(name, "histogram")
        bounds = Histogram(lo=h["lo"], hi=h["hi"]).bounds() + [math.inf]
        cum = 0
        for bound, n in zip(bounds, h["counts"]):
            cum += n
            le = f'le="{_fmt(bound)}"'
            lines.append(f"{_series(name + '_bucket', labels, le)} {cum}")
        lines.append(f"{_series(f'{name}_sum', labels)} {_fmt(h['sum'])}")
        lines.append(f"{_series(f'{name}_count', labels)} {h['count']}")
    return "\n".join(lines) + "\n"


def to_chrome_trace(trace: Union[Tracer, list]) -> dict:
    """chrome://tracing / Perfetto 'complete event' JSON for a tracer's
    spans (load the written file via chrome://tracing or ui.perfetto.dev
    to see where a flush epoch spends its time)."""
    events = trace.events if isinstance(trace, Tracer) else trace
    return {
        "traceEvents": [
            {"name": ev["name"], "ph": "X", "ts": ev["ts"], "dur": ev["dur"],
             "pid": 0, "tid": 0, "args": ev.get("args", {})}
            for ev in events
        ],
        "displayTimeUnit": "ms",
    }


def write_prometheus(path: str, metrics: Union[MetricsRegistry, dict]) -> None:
    with open(path, "w") as f:
        f.write(to_prometheus(metrics))


def write_chrome_trace(path: str, trace: Union[Tracer, list]) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(trace), f, indent=1)
