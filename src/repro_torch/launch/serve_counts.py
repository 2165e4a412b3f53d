"""Counting-plane serving driver of the port: two plain planes, device rings.

    PYTHONPATH=src python -m repro_torch.launch.serve_counts \
        --tenants 8 --epochs 2 --microbatches 8 --batch 1024

Stands up a `CountService` over two sketch specs -- a CMLS16 plane of
`--tenants` tenants and the narrow CMS32 metrics plane
(`metrics_qps` / `metrics_err`) -- with heavy-hitter tracking on, and
pushes a Zipfian event stream through the device-resident ingest rings.
Each flush epoch of the stream is

  * `--microbatches` calls of `enqueue_many`: one microbatch of `--batch`
    events per CMLS16 tenant (a whole-plane append, the dense kernel)
    plus 256 events for `metrics_qps` only (a one-row append, the
    row-mapped kernel);
  * one single-tenant `enqueue` on the first tenant (row-mapped append),
    which flushes the plane on queue pressure once the ring is full;

then `flush`, `query_all` over per-tenant probes, `query` and `topk`.
Every flush epoch is one fused update + score dispatch per fill class.
The run prints span and dispatch summaries off the metrics registry.

Runs on CUDA by default; `--device cpu` runs the plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import CMLS16, CMS32, SketchSpec
from repro_torch.stream import CountService

LATER_SLICES = ("not yet in the port (later slices): the windowed "
                "'trending' tenant, the admission tenant 'emb_ids', "
                "snapshot/restore and the accuracy probe")


def build_service(spec: SketchSpec, tenants: int, queue_capacity: int,
                  seed: int, track_top: int, device=None,
                  engine: str = "auto", metrics=None, tracer=None
                  ) -> CountService:
    """The driver's service: `tenants` tenants on `spec`, plus the CMS32
    metrics plane exactly as the reference driver builds it."""
    names = [f"tenant_{t:02d}" for t in range(tenants)]
    svc = CountService(spec, tenants=names, queue_capacity=queue_capacity,
                       seed=seed, track_top=track_top, metrics=metrics,
                       tracer=tracer, device=device, engine=engine)
    metrics_spec = SketchSpec(width=1024, depth=2, counter=CMS32)
    svc.add_tenant("metrics_qps", spec=metrics_spec)
    svc.add_tenant("metrics_err", spec=metrics_spec)
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


def drive_epoch(svc: CountService, many, single) -> None:
    for events in many:
        svc.enqueue_many(events)
    svc.enqueue("tenant_00", single)


def probes_for(tenants: int, n: int) -> np.ndarray:
    """(tenants + 2, n) per-tenant probes: each CMLS16 tenant's hottest
    keys, then the two metrics tenants'."""
    return np.stack([np.arange(n, dtype=np.uint32) + t * 1_000_000
                     for t in range(tenants)]
                    + [np.arange(n, dtype=np.uint32)] * 2)


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
    ap.add_argument("--track-top", type=int, default=16)
    ap.add_argument("--probes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    spec = SketchSpec(width=args.width, depth=args.depth, counter=CMLS16)
    registry = obs.MetricsRegistry()
    tracer = obs.Tracer(enabled=True, metrics=registry)
    svc = build_service(spec, args.tenants, args.queue_cap, args.seed,
                        args.track_top, device=args.device, metrics=registry,
                        tracer=tracer)
    rng = np.random.default_rng(args.seed)
    epochs = [make_epoch(rng, args.tenants, args.microbatches, args.batch)
              for _ in range(args.epochs)]

    t0 = time.perf_counter()
    for many, single in epochs:
        drive_epoch(svc, many, single)
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
        print(f"[serve_counts] plane {plane.label}: {events} events, ring "
              f"high-water {int(fill.high_water)}/"
              f"{len(plane.names) * svc.queue_capacity}")

    probes = probes_for(args.tenants, args.probes)
    counts = svc.query_all(probes)
    for name in ("tenant_00", "tenant_01", "metrics_qps"):
        vals = counts[name].cpu().numpy()[:8]
        print(f"[serve_counts] {name} hot-key counts: "
              f"{[round(float(x), 1) for x in vals]}")
    one = svc.query("tenant_00", probes[0])
    print(f"[serve_counts] query(tenant_00) agrees with query_all: "
          f"{bool(torch.equal(one, counts['tenant_00']))}")
    hot, est = svc.topk("tenant_00", 5)
    print(f"[serve_counts] tenant_00 top-5 heavy hitters (tracker-fed): "
          f"{[(int(k), round(float(v))) for k, v in zip(hot, est)]}")

    summ = tracer.summary()
    print("[serve_counts] spans: " + ", ".join(
        f"{name} x{s['count']} {s['total_us'] / 1e3:.1f}ms"
        for name, s in sorted(summ.items())))
    disp = {k: v for k, v in svc.metrics.snapshot()["counters"].items()
            if k.startswith("dispatch")}
    print(f"[serve_counts] dispatch tallies: {disp}")
    print(f"[serve_counts] {LATER_SLICES}")


if __name__ == "__main__":
    main()
