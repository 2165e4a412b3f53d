"""The port's accuracy probe and exporters against the JAX package's (CPU).

  * `AccuracyProbe`: hash sampling (the same mask for every salt and
    rate), exact shadow counts, the capacity cap and `dropped`,
    `are_by_decile` (cold to hot, None below ten keys) and `record`
    landing the same gauges and histograms, all against the reference's
    probe fed the same batches;
  * a port `CountService(probe=)` and a JAX one fed the same stream: the
    same shadow counts, and ARE deciles within the stated tolerance; the
    probe adds no dispatch to an append;
  * `to_prometheus` / `to_chrome_trace` text equal to the reference's for
    the same snapshot and events, and the launcher's `--metrics-out` /
    `--trace-out` files.

Tolerance: none.  Sampling, shadow counts and exports are integer or text
work; ARE deciles come from the services' estimates, which are equal bit
for bit in every format (test_torch_service), so the deciles are equal.
"""
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import counters as jc
from repro.core import sketch as jsk
from repro.stream import CountService as JService
from repro_torch import obs as tobs
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve_counts
from repro_torch.stream import CountService as TService


def _zipf(n, vocab, seed=0):
    return (np.random.default_rng(seed).zipf(1.3, n) % vocab).astype(
        np.uint32)


def _probes(**kw):
    return jobs.AccuracyProbe(**kw), tobs.AccuracyProbe(**kw)


# --------------------------------------------------------------------------
# the probe alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rate,salt", [(0.05, None), (0.25, 7),
                                       (1.0, None), (0.5, 0xFFFFFFFF)])
def test_probe_sampling_matches(rate, salt):
    kw = {"rate": rate} if salt is None else {"rate": rate, "salt": salt}
    jp, tp = _probes(**kw)
    keys = np.random.default_rng(1).integers(0, 2**32, 50_000,
                                             dtype=np.uint64).astype(
                                                 np.uint32)
    keys[:3] = [0, 1, 0xFFFFFFFF]
    np.testing.assert_array_equal(tp.sampled(keys), jp.sampled(keys))
    assert tp._threshold == jp._threshold and tp.salt == jp.salt


@pytest.mark.parametrize("capacity", [8, 4096])
def test_probe_shadow_counts_and_capacity_match(capacity):
    jp, tp = _probes(rate=0.5, capacity=capacity)
    for i in range(4):
        batch = _zipf(3000, 700, seed=i)
        for p in (jp, tp):
            p.observe("t", batch)
            p.observe("u", batch[::3])
            p.observe("t", batch[:0])
    assert tp.counts == jp.counts and tp.dropped == jp.dropped
    assert len(tp.counts["t"]) <= capacity
    assert (tp.dropped > 0) == (capacity == 8)
    for tenant in ("t", "u", "none"):
        for got, want in zip(tp.shadowed(tenant), jp.shadowed(tenant)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_probe_are_by_decile_and_record_match():
    jp, tp = _probes(rate=1.0)
    batch = _zipf(4000, 500, seed=2)
    jp.observe("t", batch)
    tp.observe("t", batch)
    tp.observe("few", batch[:3])
    jp.observe("few", batch[:3])
    exact = dict(zip(*(x.tolist() for x in tp.shadowed("t"))))

    def est(keys):   # over by 3 everywhere: error falls cold -> hot
        return np.array([exact[int(k)] + 3 for k in keys], np.float64)

    want = jp.are_by_decile(est, "t")
    got = tp.are_by_decile(lambda k: torch.from_numpy(est(k)), "t")
    assert got == want and len(got) == 10 and got[0] > got[-1]
    assert tp.are_by_decile(est, "few") is None
    assert tp.are_by_decile(est, "none") is None

    class Svc:
        def __init__(self, metrics):
            self.metrics = metrics

        def query(self, tenant, keys):
            return est(keys)

    jm, tm = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    assert tp.record(Svc(tm)) == jp.record(Svc(jm)) == {"t": want}
    assert tm.snapshot() == jm.snapshot()
    snap = tm.snapshot()
    assert snap["histograms"]['accuracy_are{tenant="t"}']["count"] == 10
    assert 'accuracy_are_decile{decile="9",tenant="t"}' in snap["gauges"]


@pytest.mark.parametrize("kw", [dict(rate=0.0), dict(rate=1.5),
                                dict(capacity=0)])
def test_probe_validation(kw):
    with pytest.raises(ValueError):
        jobs.AccuracyProbe(**kw)
    with pytest.raises(ValueError):
        tobs.AccuracyProbe(**kw)


# --------------------------------------------------------------------------
# the probe on a service
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CMS32", "CMLS16"])
def test_service_probe_matches_reference(name):
    js = jsk.SketchSpec(width=512, depth=2, counter=getattr(jc, name))
    ts = tsk.SketchSpec(width=512, depth=2, counter=getattr(tc, name))
    jp, tp = _probes(rate=0.3, capacity=64)
    names = ["a", "b", "c"]
    a = JService(js, tenants=names, queue_capacity=1024, seed=3,
                 track_top=8, probe=jp)
    b = TService(ts, tenants=names, queue_capacity=1024, seed=3,
                 track_top=8, probe=tp, device="cpu")
    for step in range(3):
        events = {n: _zipf(600, 400, seed=10 * step + i) + 1000 * i
                  for i, n in enumerate(names)}
        a.enqueue_many(events)
        b.enqueue_many(events)
        single = _zipf(1500, 400, seed=99 + step)   # overflows: flushes
        a.enqueue("b", single)
        b.enqueue("b", single)
    a.flush()
    b.flush()
    assert tp.counts == jp.counts and tp.dropped == jp.dropped
    want = jp.record(a)
    got = tp.record(b)
    assert sorted(got) == sorted(want) == names
    for n in names:
        assert got[n] == want[n]
    gauges = b.metrics.snapshot()["gauges"]
    assert gauges['accuracy_are_decile{decile="0",tenant="a"}']["value"] \
        == got["a"][0]


def test_probe_adds_no_dispatch_to_an_append():
    ts = tsk.SketchSpec(width=256, depth=2, counter=tc.CMLS16)
    events = {"a": _zipf(300, 100), "b": _zipf(200, 100, seed=1)}
    tallies = []
    for probe in (None, tobs.AccuracyProbe(rate=1.0)):
        svc = TService(ts, tenants=["a", "b"], queue_capacity=1024,
                       probe=probe, device="cpu")
        with tops.audit_scope() as tally:
            svc.enqueue_many(events)
            svc.enqueue("a", events["a"])
        tallies.append(dict(tally))
    assert tallies[0] == tallies[1] == {"queue_append": 2}


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------

def _fill(reg):
    reg.counter("events").inc(12345)
    reg.counter("dispatch", op="query").inc(3)
    reg.counter("weights", plane="p0").inc(2.5)
    reg.gauge("ring_fill", plane="p0").set(17)
    reg.gauge("ring_fill", plane="p0").set(5)
    reg.gauge("lag", plane="w0", tenant="x").set(0.25)
    h = reg.histogram("span_duration_us", lo=0, hi=24, span="flush")
    for v in (0.5, 3.0, 1e3, 2.5e7, 0.0):
        h.observe(v)
    reg.histogram("accuracy_are", lo=-10, hi=6, tenant="t").observe(0.125)
    return reg


def test_prometheus_text_matches_reference(tmp_path):
    jreg, treg = _fill(jobs.MetricsRegistry()), _fill(tobs.MetricsRegistry())
    want = jobs.to_prometheus(jreg)
    assert tobs.to_prometheus(treg) == want
    assert tobs.to_prometheus(jreg.snapshot()) == want   # from a snapshot
    assert "span_duration_us_bucket{span=\"flush\",le=\"+Inf\"} 5" in want
    path = tmp_path / "m.prom"
    tobs.write_prometheus(str(path), treg)
    assert path.read_text() == want
    assert tobs.to_prometheus({}) == jobs.to_prometheus({}) == "\n"


def test_chrome_trace_matches_reference(tmp_path):
    tracer = tobs.Tracer(enabled=True)
    with tracer.span("flush_epoch", plane="p0"):
        pass
    with tracer.span("query") as sp:
        sp.sync(torch.zeros(2))
    want = jobs.to_chrome_trace(list(tracer.events))
    got = tobs.to_chrome_trace(tracer)
    assert got == want
    assert [e["name"] for e in got["traceEvents"]] == ["flush_epoch",
                                                       "query"]
    assert got["traceEvents"][1]["args"]["synced"] is True
    path = tmp_path / "t.json"
    tobs.write_chrome_trace(str(path), tracer)
    assert json.loads(path.read_text()) == json.loads(json.dumps(want))


def test_launcher_writes_metrics_and_trace(tmp_path, capsys):
    prom, trace = tmp_path / "serve.prom", tmp_path / "trace.json"
    serve_counts.main(["--device", "cpu", "--tenants", "2", "--epochs", "1",
                       "--microbatches", "2", "--batch", "512",
                       "--probe-rate", "0.5", "--metrics-out", str(prom),
                       "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "ARE by decile (cold->hot" in out
    assert "span latency (p50/p99 bucket bounds)" in out
    assert "not yet in the port" not in out
    text = prom.read_text()
    assert "# TYPE accuracy_are_decile gauge" in text
    assert 'accuracy_are_decile{decile="9",tenant="tenant_00"}' in text
    assert "span_duration_us_bucket{span=\"enqueue_many\"" in text
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"enqueue_many", "flush_epoch", "query_all"} <= names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
