"""Telemetry plane (the port's own copies): metrics registry, span
tracer, exporters and the accuracy SLO probe.

  * `registry` -- scoped counters / gauges (with high-water marks) /
    log2-bucket histograms behind one `MetricsRegistry`, snapshot-able to
    a plain JSON dict and mergeable across shards (`merge_snapshots`).
  * `trace`    -- a `Tracer` of named spans around the hot path; an
    enabled span closes after a `torch.cuda.synchronize`, a disabled one
    costs nothing.
  * `export`   -- Prometheus text exposition of registry snapshots and
    chrome://tracing JSON of spans (`launch/serve_counts.py
    --metrics-out / --trace-out`).
  * `probes`   -- `AccuracyProbe`: a hash-sampled exact shadow counter
    whose `are_by_decile` is the paper's ARE-by-frequency-decile
    evaluation as a live metric.
"""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, merge_snapshots)
from repro_torch.obs.trace import Span, Tracer
from repro_torch.obs.export import (to_chrome_trace, to_prometheus,
                                    write_chrome_trace, write_prometheus)
from repro_torch.obs.probes import AccuracyProbe

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "merge_snapshots",
    "Span", "Tracer",
    "to_chrome_trace", "to_prometheus", "write_chrome_trace",
    "write_prometheus",
    "AccuracyProbe",
]
