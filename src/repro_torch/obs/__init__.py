"""Telemetry: metrics registry and span tracer (the port's own copies)."""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, merge_snapshots)
from repro_torch.obs.trace import Span, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "merge_snapshots", "Span", "Tracer"]
