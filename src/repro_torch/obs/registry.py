"""Scoped metrics registry: counters, gauges, log2-bucket histograms.

The port's own copy of `repro/obs/registry.py` (the two packages share
no module).  Zero dependencies and host-side by design: instruments are
plain Python numbers the serving stack bumps from the host control path
(per-op dispatch tallies come in through `kernels.ops.audit_scope`, not
per-launch callbacks).

Identity is (name, sorted labels): asking for the same instrument twice
returns the same object, so call sites never coordinate.  The whole
registry snapshots to a plain JSON dict and loads back;
`merge_snapshots` combines per-shard snapshots (counters and histogram
buckets sum, gauges take the max).
"""
from __future__ import annotations

import math
import threading
from typing import Iterable, Optional


def _key(name: str, labels: dict) -> str:
    """Stable instrument key: `name{k="v",...}` in sorted label order
    (the Prometheus series identity, reused as the snapshot dict key)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone counter (floats allowed: event weights count too)."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0):
        self.value = value

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc {n})")
        self.value += n


class Gauge:
    """Point-in-time value with an automatic high-water mark."""

    __slots__ = ("value", "high_water")

    def __init__(self, value: float = 0, high_water: float = 0):
        self.value = value
        self.high_water = high_water

    def set(self, v: float) -> None:
        self.value = v
        if v > self.high_water:
            self.high_water = v


class Histogram:
    """Fixed log2-bucket histogram: bucket i counts values <= 2**(lo + i).

    The bounds are static per instrument (`lo`..`hi` exponents plus a
    +inf overflow bucket), so two shards' histograms merge by elementwise
    bucket addition and the Prometheus exposition is cumulative by
    construction.  Values <= 0 land in the first bucket (ARE of 0 is a
    perfect estimate, not an error).
    """

    __slots__ = ("lo", "hi", "counts", "sum", "count")

    def __init__(self, lo: int = -10, hi: int = 10,
                 counts: Optional[list] = None, sum: float = 0.0,
                 count: int = 0):
        if hi <= lo:
            raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
        self.lo = int(lo)
        self.hi = int(hi)
        n = self.hi - self.lo + 2  # bounds lo..hi inclusive, then +inf
        if counts is None:
            counts = [0] * n
        elif len(counts) != n:
            raise ValueError(f"expected {n} buckets for [{lo}, {hi}], "
                             f"got {len(counts)}")
        self.counts = list(counts)
        self.sum = float(sum)
        self.count = int(count)

    def bounds(self) -> list[float]:
        """Upper bounds of the finite buckets (2**lo .. 2**hi)."""
        return [2.0 ** e for e in range(self.lo, self.hi + 1)]

    def observe(self, v: float) -> None:
        v = float(v)
        if v <= 0:
            i = 0
        else:
            i = min(max(math.ceil(math.log2(v)) - self.lo, 0),
                    len(self.counts) - 1)
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Upper-bound q-quantile from the log2 buckets (the value every
        scraper computes from the cumulative Prometheus exposition; here
        for hosts printing p50/p99 without a scraper in the loop).
        Returns the upper bound of the first bucket whose cumulative
        count reaches q * count — conservative by at most one bucket
        (one power of two), +inf if the overflow bucket is the answer,
        0.0 on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        bounds = self.bounds()
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if c and seen >= rank:
                return bounds[i] if i < len(bounds) else math.inf
        return math.inf


class MetricsRegistry:
    """Get-or-create instrument registry, snapshot-able as a JSON dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, _key(name, labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, _key(name, labels))

    def histogram(self, name: str, lo: int = -10, hi: int = 10,
                  **labels) -> Histogram:
        key = _key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(lo=lo, hi=hi)
        return h

    def _get(self, store, cls, key):
        with self._lock:
            inst = store.get(key)
            if inst is None:
                inst = store[key] = cls()
        return inst

    # ---- snapshot / restore ----

    def snapshot(self) -> dict:
        """Plain-JSON view of every instrument (manifest v5 persists it)."""
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: {"value": g.value, "high_water": g.high_water}
                       for k, g in self._gauges.items()},
            "histograms": {k: {"lo": h.lo, "hi": h.hi,
                               "counts": list(h.counts), "sum": h.sum,
                               "count": h.count}
                           for k, h in self._histograms.items()},
        }

    def load(self, snap: dict) -> None:
        """Overlay a snapshot: named instruments are restored in place
        (instrument objects already handed out stay live — a restored
        service keeps counting into the same Counter)."""
        for k, v in snap.get("counters", {}).items():
            self._get(self._counters, Counter, k).value = v
        for k, v in snap.get("gauges", {}).items():
            g = self._get(self._gauges, Gauge, k)
            g.value, g.high_water = v["value"], v["high_water"]
        for k, v in snap.get("histograms", {}).items():
            with self._lock:
                h = self._histograms.get(k)
                if h is None:
                    h = self._histograms[k] = Histogram(lo=v["lo"], hi=v["hi"])
            h.counts = list(v["counts"])
            h.sum, h.count = float(v["sum"]), int(v["count"])

    def reset(self) -> None:
        """Zero every instrument in place (handed-out objects included)."""
        for c in self._counters.values():
            c.value = 0
        for g in self._gauges.values():
            g.value = g.high_water = 0
        for h in self._histograms.values():
            h.counts = [0] * len(h.counts)
            h.sum, h.count = 0.0, 0


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Merge per-shard registry snapshots: counters and histogram buckets
    sum (each shard counted disjoint work), gauges take the max of values
    and high-waters (the fleet-wide envelope).  Histograms must agree on
    bucket bounds — they do by construction when every shard runs the same
    instrument code."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, v in snap.get("gauges", {}).items():
            g = out["gauges"].setdefault(
                k, {"value": -math.inf, "high_water": -math.inf})
            g["value"] = max(g["value"], v["value"])
            g["high_water"] = max(g["high_water"], v["high_water"])
        for k, v in snap.get("histograms", {}).items():
            h = out["histograms"].get(k)
            if h is None:
                out["histograms"][k] = {"lo": v["lo"], "hi": v["hi"],
                                        "counts": list(v["counts"]),
                                        "sum": v["sum"], "count": v["count"]}
                continue
            if (h["lo"], h["hi"]) != (v["lo"], v["hi"]):
                raise ValueError(f"histogram {k}: shard bucket bounds "
                                 f"disagree ({h['lo']},{h['hi']}) vs "
                                 f"({v['lo']},{v['hi']})")
            h["counts"] = [a + b for a, b in zip(h["counts"], v["counts"])]
            h["sum"] += v["sum"]
            h["count"] += v["count"]
    return out
