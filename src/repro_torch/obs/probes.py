"""Accuracy SLO probes: sampled exact shadow counts + ARE by decile.

The paper's pitch is an accuracy-for-memory trade, so accuracy must be a
*tracked runtime metric*, not a one-off bench plot.  `AccuracyProbe`
shadows a slice of the enqueued key space with exact host-side counts
and periodically scores the serving plane against them:

  * SAMPLING -- a key is shadowed iff fmix32(key ^ salt) clears a rate
    threshold (deterministic hash sampling).  Unlike a reservoir over
    *occurrences*, every occurrence of a shadowed key is counted from
    stream start, so the shadow counts are exact, and the sampled slice
    is an unbiased cut of the key universe (hot and cold keys alike).
    Memory is bounded twice over: expected distinct shadowed keys is
    (distinct keys) * rate, and a hard `capacity` cap stops admitting
    new keys when full (`dropped` counts what the cap cost).
  * SCORING -- `are_by_decile` queries the service for every shadowed
    key, splits keys into frequency deciles by their TRUE counts
    (decile 0 = coldest tenth, 9 = hottest -- the source paper's
    ARE-by-frequency-decile evaluation), and returns the mean absolute
    relative error per decile.  `record` registers the result as
    registry metrics: an `accuracy_are` histogram (log2 buckets) plus
    `accuracy_are_decile{decile=...}` gauges per tenant.

The port's own copy of `repro/obs/probes.py` (the two packages share no
module): host numpy only, so observing an enqueued batch launches
nothing and issues no synchronize.  `record` reads the service through
`svc.query`, whose answers it moves to the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.obs.registry import MetricsRegistry

_C1 = np.uint32(0x85EB_CA6B)
_C2 = np.uint32(0xC2B2_AE35)
_SALT = np.uint32(0xA11C_E5ED)


def _fmix32(x: np.ndarray) -> np.ndarray:
    """Murmur3 finalizer on host numpy (wraps mod 2^32), matching the
    avalanche quality of `core.hashing.mix32` without device dispatches
    on the enqueue path."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = x * _C1
        x = x ^ (x >> np.uint32(13))
        x = x * _C2
        x = x ^ (x >> np.uint32(16))
    return x


def _host(est) -> np.ndarray:
    """Estimates (a tensor on any device, or an array) as float64 numpy."""
    if isinstance(est, torch.Tensor):
        est = est.detach().cpu().numpy()
    return np.asarray(est, np.float64)


class AccuracyProbe:
    """Exact shadow counter over a hash-sampled slice of the key space."""

    def __init__(self, rate: float = 0.05, capacity: int = 4096,
                 salt: int = int(_SALT)):
        if not 0 < rate <= 1:
            raise ValueError(f"sample rate must be in (0, 1], got {rate}")
        if capacity < 1:
            raise ValueError("capacity must be positive")
        self.rate = float(rate)
        self.capacity = int(capacity)
        self.salt = np.uint32(salt)
        self._threshold = np.uint32(min(int(rate * 2.0 ** 32), 2 ** 32 - 1))
        # {tenant: {key: exact count}} -- bounded by capacity per tenant
        self.counts: dict[str, dict[int, int]] = {}
        self.dropped = 0  # shadow-worthy keys refused by the capacity cap

    def sampled(self, keys: np.ndarray) -> np.ndarray:
        """Mask of keys that belong to the shadowed slice."""
        return _fmix32(np.asarray(keys)) ^ self.salt < self._threshold

    def observe(self, tenant: str, keys) -> None:
        """Count the shadowed keys of one enqueued microbatch (host-side
        numpy: a hash + filter per batch, no device work)."""
        keys = np.asarray(keys).ravel()
        if keys.size == 0:
            return
        hit = keys[self.sampled(keys)]
        if hit.size == 0:
            return
        table = self.counts.setdefault(tenant, {})
        uniq, n = np.unique(hit, return_counts=True)
        for k, c in zip(uniq.tolist(), n.tolist()):
            if k in table:
                table[k] += c
            elif len(table) < self.capacity:
                table[k] = c
            else:
                self.dropped += c

    def shadowed(self, tenant: str) -> tuple[np.ndarray, np.ndarray]:
        """(keys, exact counts) currently shadowed for one tenant."""
        table = self.counts.get(tenant, {})
        if not table:
            return (np.zeros(0, np.uint32), np.zeros(0, np.int64))
        keys = np.fromiter(table.keys(), np.uint32, len(table))
        true = np.fromiter(table.values(), np.int64, len(table))
        return keys, true

    def are_by_decile(self, query_fn, tenant: str, deciles: int = 10
                      ) -> Optional[list[float]]:
        """Mean absolute relative error per frequency decile.

        query_fn(keys) -> estimates for `tenant` (e.g. a bound
        `svc.query(tenant, ...)`).  Keys sort by TRUE count; decile 0 is
        the coldest tenth, decile `deciles-1` the hottest.  Returns None
        when the tenant has fewer shadowed keys than deciles (no stable
        split to report yet).
        """
        keys, true = self.shadowed(tenant)
        if keys.size < deciles:
            return None
        est = _host(query_fn(keys))
        rel = np.abs(est - true) / np.maximum(true, 1)
        order = np.argsort(true, kind="stable")
        splits = np.array_split(rel[order], deciles)
        return [float(np.mean(s)) for s in splits]

    def record(self, svc, metrics: Optional[MetricsRegistry] = None,
               deciles: int = 10) -> dict[str, list[float]]:
        """Score every shadowed tenant against the live service and
        register the result: one `accuracy_are` histogram observation per
        decile plus `accuracy_are_decile{tenant=,decile=}` gauges.
        Returns {tenant: [are per decile]} (tenants without enough
        shadowed keys are skipped)."""
        metrics = metrics if metrics is not None else getattr(svc, "metrics",
                                                              None)
        out: dict[str, list[float]] = {}
        for tenant in self.counts:
            ares = self.are_by_decile(
                lambda k, t=tenant: svc.query(t, k), tenant, deciles=deciles)
            if ares is None:
                continue
            out[tenant] = ares
            if metrics is None:
                continue
            hist = metrics.histogram("accuracy_are", lo=-10, hi=6,
                                     tenant=tenant)
            for d, v in enumerate(ares):
                hist.observe(v)
                metrics.gauge("accuracy_are_decile", tenant=tenant,
                              decile=str(d)).set(v)
        return out
