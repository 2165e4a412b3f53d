"""The one traffic generator: n-gram events of the paper's corpus model.

Copied from the port's `data/corpus.py` and `data/ngrams.py` (as they
stood when the benchmark was defined; no code path shares them): tokens
drawn from a Zipf-Mandelbrot law (exponent s, shift q) over a ranked
vocabulary, where with probability p_copy a phrase of 2 + geometric
tokens is copied from a uniformly drawn earlier position, the rate and
exponent calibrated to the paper's 20newsgroups slice (about 233k
distinct unigrams and bigrams per 500k words).  The copy there is a
Python loop of one iteration a token; here it is vectorised: the stream
is cut into segments (a fresh token, or a copy of its own length and
source), every position points at the position it copies, and the
pointers are followed by doubling.  Each token position yields two
events, its unigram key (the token id) and the bigram key of it and the
next token (`combine2`, the sketch's feature cross), in one stream.

All draws come from one `torch.Generator` seeded with --seed, on the
run's device, in a few large calls.  A traffic file (traffic/<mix>.json)
sets the sizes: events a tenant a microbatch, microbatches an epoch, the
metrics tenant's share, event time, probes a read, the pool's length.
The pool is replayed in order, cyclically: every seed sends the same
sizes and the same event times, the mid-quantiles of the exponential law
in bit-reversed order (large and small gaps interleaved), so the number
of boundary crossings, and with it the flushes and rotations, is the
same for every seed; only the keys come from the seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MASK32 = 0xFFFF_FFFF
_C1, _C2, _GOLDEN = 0x85EB_CA6B, 0xC2B2_AE35, 0x9E37_79B1


def _mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def combine2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bigram key of token ids a, b (int64 holding uint32)."""
    return _mix((_mul32(a, _GOLDEN) + _mix(b ^ _C1)) & MASK32)


def tokens(gen: torch.Generator, rows: int, n: int, corpus: dict,
           device) -> torch.Tensor:
    """(rows, n) int64 token ids: `rows` independent streams."""
    v = int(corpus["vocab_size"])
    ranks = torch.arange(1, v + 1, dtype=torch.float64, device=device)
    p = 1.0 / (ranks + corpus["zipf_q"]) ** corpus["zipf_s"]
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand((rows, n), generator=gen, dtype=torch.float64,
                   device=device)
    fresh = torch.searchsorted(cdf, u).clamp_max(v - 1)
    # segments: a fresh token, or a copy of 2 + geometric tokens from an
    # earlier position; n segments always cover n positions
    is_copy = torch.rand((rows, n), generator=gen, device=device) \
        < corpus["p_copy"]
    geo = torch.empty((rows, n), dtype=torch.float64, device=device)
    geo.geometric_(1.0 / max(corpus["copy_len"] - 1, 1), generator=gen)
    length = torch.where(is_copy, 2 + geo.to(torch.int64), 1)
    lead = 256                                   # the first tokens are fresh
    begin = lead + torch.cumsum(length, 1) - length   # (rows, n)
    frac = torch.rand((rows, n), generator=gen, dtype=torch.float64,
                      device=device)
    span = (begin - length).clamp_min(0)
    start = torch.where(begin > length, (frac * span).to(torch.int64), 0)
    pos = torch.arange(n, device=device).expand(rows, n).contiguous()
    seg = (torch.searchsorted(begin, pos, right=True) - 1).clamp_min(0)
    off = pos - torch.gather(begin, 1, seg)
    copied = torch.gather(is_copy, 1, seg) & (pos >= lead)
    src = torch.where(copied, torch.gather(start, 1, seg) + off, pos)
    src = torch.minimum(src, pos)            # a copy reads an earlier slot
    for _ in range(64):                      # follow pointers by doubling
        nxt = torch.gather(src, 1, src)
        if torch.equal(nxt, src):
            break
        src = nxt
    return torch.gather(fresh, 1, src)


def events(tok: torch.Tensor, count: int) -> torch.Tensor:
    """(rows, count) int64 keys: unigram, bigram, unigram, ... of each
    row's tokens (count // 2 + 1 tokens a row are read)."""
    rows = tok.shape[0]
    half = -(-count // 2)
    a, b = tok[:, :half], tok[:, 1:half + 1]
    out = torch.stack([a, combine2(a, b)], dim=2).reshape(rows, -1)
    return out[:, :count]


def gap_quantiles(mean: float, n: int) -> np.ndarray:
    """The n mid-quantiles of an exponential law of mean `mean` (n a
    power of two), in bit-reversed order of rank."""
    bits = n.bit_length() - 1
    assert n == 1 << bits, "the number of gaps is a power of two"
    rank = [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
            for i in range(n)]
    q = (np.asarray(rank) + 0.5) / n
    return -mean * np.log1p(-q)


@dataclasses.dataclass
class Pool:
    """Host arrays the benchmark hands the service, replayed in order.

    keys (tenants, pool_events) uint32; metrics (pool_micro, m) uint32;
    gaps (n_gaps,) float64 seconds; probes (batches, N) uint32."""
    keys: np.ndarray
    metrics: np.ndarray | None
    gaps: np.ndarray | None
    probes: np.ndarray | None


def make_pool(traffic: dict, tenants: int, seed: int, device) -> Pool:
    """The run's traffic pool, drawn from `seed` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    corpus = traffic["corpus"]
    micro = int(traffic["microbatches"])
    per = int(traffic["events_per_tenant"])
    pool_units = int(traffic["pool_units"])
    count = pool_units * micro * per
    tok = tokens(gen, tenants, count // 2 + 2, corpus, device)
    out = {"keys": events(tok, count)}
    m = int(traffic.get("metrics_events", 0))
    if m:
        t = tokens(gen, 1, pool_units * micro * m + 1, corpus, device)
        out["metrics"] = (t[0, :pool_units * micro * m]
                          % int(traffic["metrics_keys"])).reshape(-1, m)
    n_probe = int(traffic.get("probes", 0))
    if n_probe:
        nb = int(traffic["probe_batches"])
        t = tokens(gen, nb, n_probe // 2 + 2, corpus, device)
        out["probes"] = events(t, n_probe)
    et = traffic.get("event_time")
    gaps = None
    if et:
        gaps = gap_quantiles(float(et["mean_gap_s"]), int(et["gaps"]))
    host = {k: v.to(torch.int64).cpu().numpy().astype(np.uint32)
            for k, v in out.items()}
    return Pool(keys=host["keys"], metrics=host.get("metrics"), gaps=gaps,
                probes=host.get("probes"))


class Plan:
    """The calls a run makes, unit by unit (an epoch of microbatches, or
    a read cycle), from the pool; `unit(i)` is the same for the same i,
    the pool replayed cyclically."""

    def __init__(self, traffic: dict, pool: Pool, names, metrics_name=None):
        self.traffic = traffic
        self.pool = pool
        self.names = list(names)
        self.metrics_name = metrics_name
        self.micro = int(traffic["microbatches"])
        self.per = int(traffic["events_per_tenant"])
        self.units = int(traffic["pool_units"])
        et = traffic.get("event_time")
        self.timed = bool(et)

    def ts_of(self, i: int, j: int) -> float:
        """Event time of microbatch j of unit i: the gaps summed."""
        g = self.pool.gaps
        k = i * self.micro + j + 1           # microbatches so far, this one
        whole, part = divmod(k, g.size)
        return float(whole * g.sum() + g[:part].sum())

    def microbatches(self, i: int):
        """[(events {tenant: keys}, metrics {tenant: keys} or None, ts or
        None)] of unit i."""
        u = i % self.units
        out = []
        for j in range(self.micro):
            lo = (u * self.micro + j) * self.per
            ev = {n: self.pool.keys[t, lo:lo + self.per]
                  for t, n in enumerate(self.names)}
            met = None
            if self.pool.metrics is not None:
                met = {self.metrics_name:
                       self.pool.metrics[u * self.micro + j]}
            out.append((ev, met, self.ts_of(i, j) if self.timed else None))
        return out

    def events_in(self) -> int:
        """Events one unit hands the service."""
        m = 0 if self.pool.metrics is None else self.pool.metrics.shape[1]
        return self.micro * (self.per * len(self.names) + m)

    def probes(self, i: int):
        p = self.pool.probes
        return None if p is None else p[i % p.shape[0]]
