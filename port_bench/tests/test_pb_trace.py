"""The traced slice's program readings: the spans the program records with
its tracer on and the profiler ranges it opens (`cml.<span>`), read into
the per-layer metrics on a CPU run of each cell, beside the staging
counters; the program's ranges leave what the trace read before them as
it was; and the idle gaps the trace puts down to the program's ranges,
on a trace made by hand."""
import types

import numpy as np
import pytest

from conftest import CELLS, tiny
from harness import profiling, program, runner

SEED = 2**31 + 4099
SUFFIX = {"ngram-tracked-ingest": "ingest", "ngram-window-ingest": "window"}
# readers of the spans the tracer records: a reading on any device
SPANS = {"ngram-tracked-ingest": ("ring_stage_ms.ingest",
                                  "dedup_sort_ms.ingest",
                                  "tracker_ms.ingest"),
         "ngram-window-ingest": ("ring_stage_ms.window",
                                 "uniforms_ms.window")}


def _traced_run(cell, monkeypatch, ranges=True, device="cpu"):
    """A traced run of the tiny cell; returns (result, what the profiled
    slice saw: the read trace, the microbatches handed to `enqueue_many`
    (per call, each plane's batch sizes), the bytes handed to the shared
    staging (`handed`) and the change of the upload bytes)."""
    from repro_torch.core import staging
    seen = {"handed": []}
    build, profile, read = program.build, profiling.profile, profiling.read
    upload = staging.HostStaging.upload

    def upload_(self, *arrays):
        if "appends" not in seen:       # inside the profiled slice
            seen["handed"].append(sum(
                -(-a.nbytes // staging.ALIGN) * staging.ALIGN
                for a in map(np.asarray, arrays)))
        return upload(self, *arrays)

    def build_(*a, **kw):
        out = build(*a, **kw)
        seen["svc"] = out[0]
        return out

    def uploads(svc):
        return svc.metrics.snapshot()["counters"].get("upload_bytes", 0)

    def profile_(drive, units, sync):
        svc, appends = seen["svc"], []
        em = svc.enqueue_many

        def enqueue_many(events, ts=None):
            by_plane = {}
            for name, keys in events.items():
                by_plane.setdefault(id(svc._lookup(name)[0]), []).append(
                    len(keys))
            appends.extend(by_plane.values())
            return em(events, ts=ts)
        svc.enqueue_many = enqueue_many
        before = uploads(svc)
        seen["handed"].clear()
        try:
            return profile(drive, units, sync)
        finally:
            del svc.enqueue_many
            seen.update(appends=appends, uploads=uploads(svc) - before)

    def read_(prof, wall):
        seen["profile"] = read(prof, wall)
        return seen["profile"]

    monkeypatch.setattr(program, "build", build_)
    monkeypatch.setattr(profiling, "profile", profile_)
    monkeypatch.setattr(profiling, "read", read_)
    monkeypatch.setattr(staging.HostStaging, "upload", upload_)
    if not ranges:
        from repro_torch.obs import trace
        monkeypatch.setattr(trace, "_recording", lambda: False)
    out = runner.run(tiny(cell), SEED, 0.05, True, 0.0, device=device)
    del seen["svc"]
    return out, seen


@pytest.mark.parametrize("cell", CELLS)
def test_program_metrics_of_a_traced_run(cell, monkeypatch):
    out, seen = _traced_run(cell, monkeypatch)
    assert out["correct"]
    metrics = out["metrics"]
    for name in SPANS[cell]:
        assert metrics[name]["value"] > 0, name
    # no device, no idle gap: nothing to put down to the program
    assert seen["profile"]["idle_gaps"] == []
    assert f"idle_in_program_ms.{SUFFIX[cell]}" not in metrics
    # the staging counters over the profiled slice: the ring's share,
    # every append's rows at its CHUNK-rounded width, and the flush's
    # inputs
    chunk = program.ops.CHUNK
    ring = sum(len(sizes) * chunk * -(-max(sizes) // chunk) * 4
               for sizes in seen["appends"])
    assert ring > 0 and seen["handed"]
    assert seen["uploads"] == ring + sum(seen["handed"])


@pytest.mark.parametrize("cell", CELLS)
def test_program_ranges_leave_the_trace_readings(cell, monkeypatch):
    _, on = _traced_run(cell, monkeypatch)
    monkeypatch.undo()
    _, off = _traced_run(cell, monkeypatch, ranges=False)
    a, b = on["profile"], off["profile"]
    for key in ("busy_s", "launches", "ranges", "idle_gaps"):
        assert a[key] == b[key], key


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_ranges_leave_the_trace_readings_on_the_card(cell,
                                                             monkeypatch):
    """On a card the profiler also puts the `cml.` ranges on the device's
    timeline; they are not device work: the launches and the `pb.*`
    ranges' calls read the same with and without them, busy time stays
    that of the same kernels (the ranges cover most of the slice, so
    counted as busy they would more than double it), no `cml.` name is
    a device operation, and idle gaps are put down to the program's
    ranges only where it opened them."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, on = _traced_run(cell, monkeypatch, device="cuda")
    monkeypatch.undo()
    _, off = _traced_run(cell, monkeypatch, ranges=False, device="cuda")
    a, b = on["profile"], off["profile"]
    assert a["launches"] == b["launches"] > 0
    assert ({k: r["calls"] for k, r in a["ranges"].items()}
            == {k: r["calls"] for k, r in b["ranges"].items()})
    assert b["busy_s"] > 0
    assert a["busy_s"] == pytest.approx(b["busy_s"], rel=0.5)
    assert not [n for n, _ in a["device_ops"]
                if n.startswith(("cml.", "pb."))]
    def program(prof):
        return [n for n, _ in prof["idle_gaps"] if n.startswith("cml.")]
    assert program(a) and not program(b)


# ---- idle gaps on a hand-made trace ----------------------------------

class _Ev:
    def __init__(self, name, start, end, cpu=True, corr=0, tid=1,
                 annotation=False):
        self._n, self._s, self._e = name, start, end
        self._cpu, self._corr, self._tid = cpu, corr, tid
        self._ann = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CPU if self._cpu
                else torch.autograd.DeviceType.CUDA)

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return self._ann


def _prof(events):
    kineto = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=kineto))


def _reader(name):
    from harness import spec
    return spec.load_reader(name, spec.ROOT)


def test_idle_gaps_go_to_the_innermost_program_range():
    """enqueue_many [0, 100] holds ring_stage [10, 40], which holds the
    torch operation aten::empty [36, 39]; flush [135, 170] holds dedup
    [138, 142].  Kernels launched at 12, 44, 110 and 145 run [20, 30],
    [45, 50], [120, 130] and [150, 160]; the device's annotation of
    enqueue_many [20, 50] is no work.  Gaps: [30, 45] (middle 37.5: in
    aten::empty, not the program's own code), [50, 120] (middle 85:
    enqueue_many) and [130, 150] (middle 140: dedup)."""
    ev = [_Ev("cml.enqueue_many", 0, 100), _Ev("cml.ring_stage", 10, 40),
          _Ev("aten::empty", 36, 39), _Ev("cml.flush", 135, 170),
          _Ev("cml.dedup", 138, 142),
          _Ev("cml.enqueue_many", 20, 50, cpu=False, annotation=True)]
    for corr, (t, a, d) in enumerate(((12, 20, 10), (44, 45, 5),
                                      (110, 120, 10), (145, 150, 10))):
        ev += [_Ev("cudaLaunchKernel", t, t + 1, corr=corr),
               _Ev(f"k{corr}", a, a + d, cpu=False, corr=corr)]
    out = profiling.read(_prof(ev), 1e-6)
    assert out["busy_s"] == pytest.approx(35e-9) and out["launches"] == 4
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"cml.enqueue_many": 70e-9, "cml.dedup": 20e-9,
         "aten::empty": 15e-9})
    ctx = {"profile": out, "units": 2}
    for cell in CELLS:
        got = _reader(f"idle_in_program_ms.{SUFFIX[cell]}")(ctx)
        assert got == pytest.approx(1e3 * 90e-9 / 2)


def test_idle_in_program_reads_nothing_without_the_programs_ranges():
    """The parent's trace: no `cml.` range, so no reading (not 0)."""
    ev = [_Ev("aten::empty", 0, 100)]
    for corr, (t, a) in enumerate(((10, 20), (50, 60))):
        ev += [_Ev("cudaLaunchKernel", t, t + 1, corr=corr),
               _Ev(f"k{corr}", a, a + 10, cpu=False, corr=corr)]
    out = profiling.read(_prof(ev), 1e-6)
    assert dict(out["idle_gaps"]) == {"aten::empty": pytest.approx(30e-9)}
    for cell in CELLS:
        assert _reader(f"idle_in_program_ms.{SUFFIX[cell]}")(
            {"profile": out, "units": 1}) is None
