"""One run of one cell: set up, warm up, measure, check, report.

    setup    the pool drawn from the seed on the device, the service
             built, the warm-up units (the first one checked from the
             empty state);
    window   units in a closed loop, one producer or one client, until
             --seconds have passed at the end of a unit; the window ends
             with the unit's flush or read and a synchronize;
    traced   (--trace 1) after the window: a profiled slice with the
             program's tracer off (device busy and idle, launches, the
             entries' device time), then a slice with the tracer on (its
             spans synchronize, so they get a slice of their own);
    check    the program's state freed, the reference recomputes the
             checked units (`harness/check.py`).

End-to-end metrics are named by the traffic file: `rate_metric` is
events landed in the window over its seconds, `latency_metric` the
`percentile`-th of every read's seconds (nearest rank), in ms.
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from harness import check as ck
from harness import profiling, spec, traffic as tr, work

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def _sample(seed: int, cell: spec.Cell, names) -> tuple:
    """(checked tenants, checked window units) drawn from the seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFF_FFFF, int(seed) >> 32])
    c = cell.traffic["check"]
    tenants = sorted(rng.choice(len(names), c["tenants"], replace=False))
    units = sorted(rng.choice(c["units_from"], c["units"], replace=False))
    out = [names[i] for i in tenants]
    if cell.traffic.get("metrics_events"):
        out.append(cell.traffic["metrics_tenant"])
    return out, [int(u) for u in units]


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", fault=None, control=False,
        root=spec.ROOT) -> dict:
    """The run's result: the contract's fields, then `seconds` (set-up by
    part, the window, the check) and last `checks` (each number compared
    with its limit)."""
    parts = {"imports": time.perf_counter() - t_start}
    mark = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    from harness import program as pg
    part("program")

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: pg.synchronize(dev))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    config, traffic = cell.config, cell.traffic
    names = pg.tenant_names(config)
    pg.start_device(dev)
    part("device")
    pool = tr.make_pool(traffic, len(names), seed, dev)
    plan = tr.Plan(traffic, pool, names, traffic.get("metrics_tenant"))
    reads = traffic["loop"] == "read"
    part("pool")
    with pg.planted(fault):
        svc, tracer, _ = pg.build(config, seed, dev)
        part("service")
        checked, window_units = _sample(seed, cell, names)
        record = {"tenants": checked, "units": {}}
        read_unit = pg.Reader()

        def drive(i, timed=None, checked_unit=False):
            pre = pg.snapshot(svc, checked) if checked_unit and i else None
            micro = plan.microbatches(i)
            if reads:
                secs, host, order = read_unit(svc, micro, plan.probes(i))
                if timed is not None:
                    timed.append(secs)
            else:
                pg.ingest_unit(svc, micro)
            if checked_unit:
                rec = {"pre": pre, "post": pg.snapshot(svc, checked)}
                if reads:
                    rec["answers"] = {n: host[order.index(n)].clone()
                                      for n in checked}
                record["units"][i] = rec

        warm = int(traffic["warmup_units"])
        for i in range(warm):
            drive(i, checked_unit=i == 0)
        sync()
        part("warmup")
        setup_s = time.perf_counter() - t_start

        # the measured window
        lat, i = [], warm
        t0 = time.perf_counter()
        while True:
            drive(i, lat, checked_unit=(i - warm) in window_units)
            i += 1
            if (time.perf_counter() - t0 >= seconds
                    and i - warm > window_units[-1]):
                break
        sync()
        window_s = time.perf_counter() - t0
        done = i - warm

        traced = None
        if trace:
            traced = _traced(svc, tracer, plan, traffic, drive, i, sync,
                             reads, dev)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        del svc
        record["units"] = _to_host(record["units"])
        if cuda:
            torch.cuda.empty_cache()
    found = forbidden_modules()
    t_check = time.perf_counter()
    numbers = ck.run_check(config, seed, plan, names, record,
                           control=control)
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": 0} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == traffic.get("rate_metric"):
                metrics[m["name"]] = {"value": plan.events_in() * done
                                      / window_s, "unit": m["unit"]}
            elif m["name"] == traffic.get("latency_metric"):
                metrics[m["name"]] = {"value": 1e3 * percentile(
                    lat, traffic["percentile"]), "unit": m["unit"]}
    result = {"correct": correct, "attempted": done, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if traced is not None:
        prof = traced["profile"]
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        ctx = dict(traced, kind=kind, cell=cell.name)
        for m in cell.per_layer:
            value = spec.load_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["forbidden"] = found
    result["seconds"] = {"setup": setup_s, "setup_parts": parts,
                         "window": window_s, "check": check_s}
    result["checks"] = checks
    return result


def _to_host(x):
    """The check's records with every tensor copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _traced(svc, tracer, plan, traffic, drive, start, sync, reads, dev):
    """The profiled slice (tracer off) and the span slice (tracer on)
    after the window, `trace_units` units each; the profiled slice's
    inputs are counted after it (`harness/work.py`)."""
    from harness import program as pg
    units = int(traffic["trace_units"])
    entries = pg.Entries()

    def step(j):
        i = start + j
        if reads:
            entries.probes = plan.probes(i)
        drive(i)

    with entries.active():
        # a pass that keeps as many calls' inputs as the profiled one, so
        # the allocator holds the memory before the profiler starts
        for j in range(units):
            step(j)
        entries.clear()
        prof, wall = profiling.profile(lambda j: step(units + j), units,
                                       sync)
    profile = profiling.read(prof, wall)
    del prof
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    least = {}
    for entry, calls in entries.calls.items():
        if not calls:
            continue
        fn = work.query_work if entry == "query_many" else work.update_work
        nbytes = ops = 0
        for c in calls:
            b, o = fn(c)
            nbytes += b
            ops += o
        least[entry] = work.least_seconds(nbytes, ops, kind)
    entries.clear()

    tracer.clear()
    tracer.enabled = True
    for j in range(units):
        drive(start + 2 * units + j)
    sync()
    tracer.enabled = False
    spans = {}
    for ev in tracer.events:
        spans.setdefault(ev["name"], []).append(ev["dur"] / 1e6)
    tracer.clear()
    return {"profile": profile, "least_s": least, "spans": spans,
            "units": units}
