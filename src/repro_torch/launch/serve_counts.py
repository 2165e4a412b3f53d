"""Counting-plane serving launcher of the port: plain and windowed planes.

    PYTHONPATH=src python -m repro_torch.launch.serve_counts \
        --tenants 8 --epochs 2 --microbatches 8 --batch 1024

Stands up a `CountService` over two sketch specs -- a CMLS16 plane of
`--tenants` tenants and the narrow CMS32 metrics plane
(`metrics_qps` / `metrics_err`) -- plus `--trending` watermark-windowed
tenants (`trending_00`, ...; 8 buckets of 60 s on the CMLS16 spec, the
reference launcher's `trending` tenant), with heavy-hitter tracking on
(`--track-top 0` turns it off), and pushes a Zipfian event stream through
the device-resident ingest rings.  Each flush epoch of the stream is

  * `--microbatches` calls of `enqueue_many`: one microbatch of `--batch`
    events per CMLS16 tenant (a whole-plane append, the dense kernel)
    plus 256 events for `metrics_qps` only (a one-row append, the
    row-mapped kernel), each followed by an `enqueue_many(..., ts=ts)` of
    `--batch` events per windowed tenant, event time advancing by
    exponential(25 s) per microbatch -- crossing a 60 s boundary flushes
    the window plane into the old bucket and rotates the rings;
  * one single-tenant `enqueue` on the first tenant (row-mapped append),
    which flushes the plane on queue pressure once the ring is full;

then `flush`, `query_all` over per-tenant probes, `query` and `topk`, and
the windowed reads (last 5 buckets, gamma-decayed, `topk`).  With
tracking on, the reference launcher's admission tenant `emb_ids`
(`AdmissionSpec(threshold=64, n_fallback=1024, table_rows=65,536)`) takes
a Zipf microbatch in every `enqueue_many` and then `admit`s 32 probe ids
from its tracker, and the whole service goes through a snapshot/restore
round trip (a temporary directory) whose reads must equal the original's.
Every tracked flush epoch is one fused update + score dispatch per fill
class.  `--tier-hot N` turns on tiered hot/cold storage
(`TierSpec(max_hot_tenants=N)`, LRU victims): each plane keeps at most N
tenants on the device and the rest in a host cold store, and the run
prints each plane's tier occupancy and its promotion, demotion and spill
counters.

The run is observed through `repro_torch.obs`: an `AccuracyProbe`
(`--probe-rate`, default 0.05) shadows a hash-sampled slice of every
enqueued key space with exact host counts, and after the run the
launcher prints the ARE by frequency decile of the first three shadowed
tenants (decile 0 the coldest keys: the paper's evaluation as a live
metric, also landed in the registry), the span summary, each span's
p50/p99 off its `span_duration_us` histogram, and the dispatch tallies.
Scrape the run with

    PYTHONPATH=src python -m repro_torch.launch.serve_counts \
        --metrics-out serve.prom --trace-out serve_trace.json

`serve.prom` is Prometheus text exposition; `serve_trace.json` loads in
chrome://tracing or Perfetto.

Runs on CUDA by default; `--device cpu` runs the plain versions.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import CMLS16, CMS32, SketchSpec
from repro_torch.core.admission import AdmissionSpec
from repro_torch.stream import CountService, TierSpec, WindowPlane, WindowSpec

# the reference launcher's tracker-fed admission tenant
EMB_IDS = AdmissionSpec(threshold=64.0, n_fallback=1024, table_rows=1 << 16)

BUCKETS = 8
INTERVAL = 60.0     # seconds of event time per window bucket
MEAN_GAP = 25.0     # mean event-time step per microbatch (exponential)


def trending_names(n: int) -> list[str]:
    return [f"trending_{i:02d}" for i in range(n)]


def build_service(spec: SketchSpec, tenants: int, queue_capacity: int,
                  seed: int, track_top, device=None,
                  engine: str = "auto", metrics=None, tracer=None,
                  trending: int = 0, admission=None,
                  tier=None, probe=None) -> CountService:
    """The launcher's service: `tenants` tenants on `spec`, the CMS32
    metrics plane exactly as the reference launcher builds it, then
    `trending` windowed tenants (WindowSpec(spec, 8 buckets, 60 s)).
    `admission` (an AdmissionSpec) arms that policy on every tenant but
    the metrics plane's; `tier` (a TierSpec) tiers every plane; `probe`
    (an AccuracyProbe) shadows every tenant's enqueued keys."""
    svc = CountService(spec, queue_capacity=queue_capacity, seed=seed,
                       track_top=track_top, metrics=metrics, tracer=tracer,
                       probe=probe, device=device, engine=engine, tier=tier)
    for t in range(tenants):
        svc.add_tenant(f"tenant_{t:02d}", admission=admission)
    metrics_spec = SketchSpec(width=1024, depth=2, counter=CMS32)
    svc.add_tenant("metrics_qps", spec=metrics_spec)
    svc.add_tenant("metrics_err", spec=metrics_spec)
    wspec = WindowSpec(sketch=spec, buckets=BUCKETS, interval=INTERVAL)
    for name in trending_names(trending):
        svc.add_tenant(name, window=wspec, admission=admission)
    return svc


def make_epoch(rng: np.random.Generator, tenants: int, microbatches: int,
               batch: int):
    """One flush epoch of traffic: a list of `enqueue_many` event dicts
    and the single-tenant `enqueue` batch that follows them.  Each tenant
    counts its own Zipf(1.3) key universe, offset by its id."""
    names = [f"tenant_{t:02d}" for t in range(tenants)]
    many = []
    for _ in range(microbatches):
        events = {}
        for t, name in enumerate(names):
            keys = (rng.zipf(1.3, batch) % 10_000) + t * 1_000_000
            events[name] = keys.astype(np.uint32)
        events["metrics_qps"] = (rng.zipf(1.3, 256) % 500).astype(np.uint32)
        many.append(events)
    single = (rng.zipf(1.3, batch) % 10_000).astype(np.uint32)
    return many, single


def make_trending(rng: np.random.Generator, tenants: int, microbatches: int,
                  batch: int, ts: float):
    """One epoch of windowed traffic: `microbatches` (events, ts) pairs,
    Zipf(1.3) keys per windowed tenant (offset by its id), event time
    advancing by exponential(25 s) per microbatch from `ts`.  Returns
    (pairs, the last ts)."""
    names = trending_names(tenants)
    pairs = []
    for _ in range(microbatches):
        ts += float(rng.exponential(MEAN_GAP))
        pairs.append(({name: ((rng.zipf(1.3, batch) % 10_000)
                              + t * 1_000_000).astype(np.uint32)
                       for t, name in enumerate(names)}, ts))
    return pairs, ts


def drive_epoch(svc: CountService, many, single, trending=()) -> None:
    """The plain microbatches, each followed by its windowed one (if
    any), then the single-tenant enqueue."""
    for i, events in enumerate(many):
        svc.enqueue_many(events)
        if trending:
            win_events, ts = trending[i]
            svc.enqueue_many(win_events, ts=ts)
    svc.enqueue("tenant_00", single)


def probes_for(tenants: int, n: int, trending: int = 0) -> np.ndarray:
    """(tenants + 2 + trending, n) per-tenant probes in registry order:
    each CMLS16 tenant's hottest keys, the two metrics tenants', then
    each windowed tenant's."""
    return np.stack([np.arange(n, dtype=np.uint32) + t * 1_000_000
                     for t in range(tenants)]
                    + [np.arange(n, dtype=np.uint32)] * 2
                    + [np.arange(n, dtype=np.uint32) + t * 1_000_000
                       for t in range(trending)])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1024,
                    help="events per CMLS16 tenant per microbatch")
    ap.add_argument("--queue-cap", type=int, default=8192)
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--track-top", type=int, default=16,
                    help="heavy-hitter heap width (0: tracking off)")
    ap.add_argument("--trending", type=int, default=1,
                    help="windowed tenants (8 x 60 s buckets)")
    ap.add_argument("--probes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--tier-hot", type=int, default=None,
                    help="turn on tiered hot/cold storage: keep at most "
                         "this many tenants per plane device-resident "
                         "(TierSpec(max_hot_tenants=...), LRU victims)")
    ap.add_argument("--metrics-out", default=None,
                    help="write Prometheus text exposition here on exit")
    ap.add_argument("--trace-out", default=None,
                    help="write a chrome://tracing JSON here on exit")
    ap.add_argument("--probe-rate", type=float, default=0.05,
                    help="hash-sample rate of the exact accuracy shadow")
    args = ap.parse_args(argv)

    spec = SketchSpec(width=args.width, depth=args.depth, counter=CMLS16)
    registry = obs.MetricsRegistry()
    tracer = obs.Tracer(enabled=True, metrics=registry)
    track_top = args.track_top or None
    slo_probe = obs.AccuracyProbe(rate=args.probe_rate)
    tier = (None if args.tier_hot is None
            else TierSpec(max_hot_tenants=args.tier_hot))
    svc = build_service(spec, args.tenants, args.queue_cap, args.seed,
                        track_top, device=args.device, metrics=registry,
                        tracer=tracer, trending=args.trending, tier=tier,
                        probe=slo_probe)
    if track_top:
        svc.add_tenant("emb_ids", admission=EMB_IDS)
    rng = np.random.default_rng(args.seed)
    epochs, ts = [], 0.0
    for _ in range(args.epochs):
        many, single = make_epoch(rng, args.tenants, args.microbatches,
                                  args.batch)
        if track_top:
            for events in many:
                events["emb_ids"] = (rng.zipf(1.3, args.batch)
                                     % 10_000).astype(np.uint32)
        trending, ts = make_trending(rng, args.trending, args.microbatches,
                                     args.batch, ts)
        epochs.append((many, single, trending))

    t0 = time.perf_counter()
    for many, single, trending in epochs:
        drive_epoch(svc, many, single, trending)
    svc.flush()
    if svc.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = int(svc.metrics.counter("events").value)
    flushes = int(svc.metrics.counter("flushes").value)
    print(f"[serve_counts] ingested {total} events for {len(svc.tenants)} "
          f"tenants across {len(svc.planes)} planes on {svc.device} in "
          f"{dt:.3f}s ({flushes} flushes)")
    for plane in svc.planes:
        fill = svc.metrics.gauge("ring_fill", plane=plane.label)
        events = int(svc.metrics.counter("plane_events",
                                         plane=plane.label).value)
        line = (f"[serve_counts] plane {plane.label}: {events} events, ring "
                f"high-water {int(fill.high_water)}/"
                f"{len(plane.names) * svc.queue_capacity}")
        if isinstance(plane, WindowPlane):
            rot = int(svc.metrics.counter("plane_rotations",
                                          plane=plane.label).value)
            lags = [int(svc.metrics.gauge("watermark_lag", plane=plane.label,
                                          tenant=n).high_water)
                    for n in plane.names]
            line += (f", {rot} bucket rotations, watermark lag high-water "
                     f"{lags} intervals")
        print(line)
    # tier occupancy and swap traffic (tiering on): the hot/cold split of
    # each plane and the promotions, demotions and spills the stream forced
    for label, occ in svc.tier_occupancy().items():
        count = {k: int(svc.metrics.counter(k, plane=label).value)
                 for k in ("tier_promotions", "tier_demotions",
                           "tier_spill_events", "tier_spill_bytes")}
        print(f"[serve_counts] tier {label}: {occ['hot']} hot / "
              f"{occ['cold']} cold tenants, {count['tier_promotions']} "
              f"promotions, {count['tier_demotions']} demotions, "
              f"{count['tier_spill_events']} spills "
              f"({count['tier_spill_bytes']} bytes)")

    probes = probes_for(args.tenants, args.probes, args.trending)
    if track_top:  # emb_ids registered last: its hottest ids
        probes = np.concatenate([probes, np.arange(
            args.probes, dtype=np.uint32)[None]])
    counts = svc.query_all(probes)
    for name in ("tenant_00", "tenant_01", "metrics_qps"):
        vals = counts[name].cpu().numpy()[:8]
        print(f"[serve_counts] {name} hot-key counts: "
              f"{[round(float(x), 1) for x in vals]}")
    one = svc.query("tenant_00", probes[0])
    print(f"[serve_counts] query(tenant_00) agrees with query_all: "
          f"{bool(torch.equal(one, counts['tenant_00']))}")
    if track_top:
        hot, est = svc.topk("tenant_00", 5)
        print(f"[serve_counts] tenant_00 top-5 heavy hitters (tracker-fed): "
              f"{[(int(k), round(float(v))) for k, v in zip(hot, est)]}")
    if args.trending:
        name = trending_names(1)[0]
        keys = np.arange(8, dtype=np.uint32)
        est_w = svc.query(name, keys, n_buckets=5).cpu().numpy()
        est_d = svc.query(name, keys, gamma=0.8).cpu().numpy()
        print(f"[serve_counts] {name} (last 5 of {BUCKETS} x "
              f"{INTERVAL:.0f}s buckets, watermark epoch "
              f"{svc.epoch_of(name)}): {[round(float(x)) for x in est_w]}")
        print(f"[serve_counts] {name} lazy-decayed (gamma=0.8/interval): "
              f"{[round(float(x)) for x in est_d]}")
        if track_top:
            hot, est = svc.topk(name, 5, n_buckets=5)
            print(f"[serve_counts] {name} top-5 over the last 5 buckets: "
                  f"{[(int(k), round(float(v))) for k, v in zip(hot, est)]}")

    if track_top:
        ids = np.arange(32, dtype=np.uint32)
        rows, admitted = svc.admit("emb_ids", ids)
        print(f"[serve_counts] admission plane: "
              f"{int(admitted.sum())}/{len(ids)} probe ids admitted to "
              f"private rows (threshold {EMB_IDS.threshold}, "
              f"{EMB_IDS.table_rows} private + {EMB_IDS.n_fallback} shared "
              f"rows); rows of ids 0-3: {rows[:4].tolist()}")

    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d, step=1)
        svc2 = CountService.restore(d, device=svc.device)
        probe = np.arange(16, dtype=np.uint32)
        same = all(torch.equal(svc.query(n, probe), svc2.query(n, probe))
                   for n in svc.tenants)
        if track_top:
            same = same and all(
                torch.equal(x, y) for x, y in zip(svc.admit("emb_ids", ids),
                                                  svc2.admit("emb_ids", ids)))
        print(f"[serve_counts] snapshot/restore roundtrip: answers match="
              f"{same}, tenants={len(svc2.tenants)}, planes="
              f"{len(svc2.planes)}, stats={svc2.stats}")

    # accuracy SLO probe: the exact shadow slice scored by frequency
    # decile (decile 0 = coldest keys); record() also lands the deciles
    # in the registry
    ares = slo_probe.record(svc)
    for tenant in sorted(ares)[:3]:
        print(f"[serve_counts] {tenant} ARE by decile (cold->hot, "
              f"{len(slo_probe.counts[tenant])} shadowed keys): "
              f"{[round(v, 3) for v in ares[tenant]]}")

    summ = tracer.summary()
    print("[serve_counts] spans: " + ", ".join(
        f"{name} x{s['count']} {s['total_us'] / 1e3:.1f}ms"
        for name, s in sorted(summ.items())))
    # per-op latency off the span histograms (log2-bucket upper bounds,
    # what a scraper derives from --metrics-out's cumulative buckets)
    pcts = []
    for name in sorted(summ):
        h = registry.histogram("span_duration_us", lo=0, hi=24, span=name)
        pcts.append(f"{name} p50<={h.quantile(0.5) / 1e3:.3g}ms "
                    f"p99<={h.quantile(0.99) / 1e3:.3g}ms")
    print(f"[serve_counts] span latency (p50/p99 bucket bounds): "
          f"{', '.join(pcts)}")
    disp = {k: v for k, v in svc.metrics.snapshot()["counters"].items()
            if k.startswith("dispatch")}
    print(f"[serve_counts] dispatch tallies: {disp}")

    if args.metrics_out:
        obs.write_prometheus(args.metrics_out, svc.metrics)
        print(f"[serve_counts] wrote Prometheus exposition -> "
              f"{args.metrics_out}")
    if args.trace_out:
        obs.write_chrome_trace(args.trace_out, tracer)
        print(f"[serve_counts] wrote chrome://tracing JSON -> "
              f"{args.trace_out}")


if __name__ == "__main__":
    main()
