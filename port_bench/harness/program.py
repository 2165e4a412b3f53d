"""The system under test: the port's CountService, built from a config.

The only module of the benchmark that imports the program (the package
`repro_torch` under src/).  It builds the service a configuration file
describes, drives it with the traffic the plan hands it, copies the
state of the tenants the check reads (device copies, in stream order:
no synchronize), wraps the program's entries in profiler ranges for a
traced slice, and plants the faults the check is shown to catch.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import CounterSpec, SketchSpec
from repro_torch.kernels import ops
from repro_torch.stream import CountService, WindowSpec

_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _signed(t: torch.Tensor) -> torch.Tensor:
    s = _SIGNED.get(t.dtype)
    return t if s is None else t.view(s)


def counter_spec(c: dict) -> CounterSpec:
    return CounterSpec(kind=c["kind"], base=c["base"], bits=c["bits"])


def sketch_spec(s: dict) -> SketchSpec:
    return SketchSpec(width=s["width"], depth=s["depth"],
                      counter=counter_spec(s["counter"]), seed=s["seed"],
                      packed=s["packed"])


def build(config: dict, seed: int, device) -> tuple:
    """(service, tracer, main tenant names): the configuration's tenants
    on one service, in the project launcher's order (sketch tenants, the
    metrics plane, windowed tenants); the tracer starts off."""
    spec = sketch_spec(config["sketch"])
    tracer = obs.Tracer(enabled=False)
    svc = CountService(spec, queue_capacity=config["queue_capacity"],
                       seed=seed & 0xFFFF_FFFF,
                       track_top=config["track_top"], tracer=tracer,
                       device=device)
    names = tenant_names(config)
    win = config.get("window")
    if win is None:
        for n in names:
            svc.add_tenant(n)
    mp = config["metrics_plane"]
    mspec = sketch_spec(mp["sketch"])
    for n in mp["tenants"]:
        svc.add_tenant(n, spec=mspec)
    if win is not None:
        wspec = WindowSpec(sketch=spec, buckets=win["buckets"],
                           interval=win["interval_s"])
        for n in names:
            svc.add_tenant(n, window=wspec)
    return svc, tracer, names


def tenant_names(config: dict) -> list:
    prefix = "trending" if config.get("window") else "tenant"
    return [f"{prefix}_{i:02d}" for i in range(config["tenants"])]


def ingest_unit(svc: CountService, micro) -> None:
    """One epoch: each microbatch's enqueue_many (the metrics tenant's
    keys in the same call, or before the event-time call), then flush."""
    for ev, met, ts in micro:
        if ts is None:
            svc.enqueue_many({**ev, **(met or {})})
        else:
            if met:
                svc.enqueue_many(met)
            svc.enqueue_many(ev, ts=ts)
    svc.flush()


class Reader:
    """The client of the read cell: it keeps one host buffer (pinned on
    CUDA) for the answers, as a client that reads every cycle does."""

    def __init__(self):
        self.host = None

    def __call__(self, svc: CountService, micro, probes: np.ndarray):
        """One read cycle: the trickle's enqueue_many, then one timed
        read, query_all of the shared probes with the answers copied into
        the host buffer.  Returns (seconds of the read, (tenants, N) host
        answers, tenant names)."""
        for ev, met, ts in micro:
            svc.enqueue_many({**ev, **(met or {})})
        t0 = time.perf_counter()
        out = svc.query_all(probes)
        answers = torch.stack(list(out.values()))
        if self.host is None or self.host.shape != answers.shape:
            self.host = torch.empty(answers.shape, dtype=answers.dtype,
                                    pin_memory=answers.is_cuda)
        self.host.copy_(answers)
        return time.perf_counter() - t0, self.host, list(out)


def start_device(device) -> None:
    """The CUDA context and the port's kernel library (built into the
    checkout's build/ on the first run there, loaded after)."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build as kbuild
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        kbuild.load()


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---- state the check reads -------------------------------------------------

def snapshot(svc: CountService, names) -> dict:
    """{tenant: state} device copies of each tenant's table (a windowed
    tenant's whole ring), ring row and heap."""
    out = {}
    for n in names:
        plane, row = svc._lookup(n)
        st = {"cells": _signed(plane.tables[row]).clone(),
              "ring": _signed(plane.ring.queue[row]).clone()}
        if plane.tracker is not None:
            tk = plane.tracker
            st["heap"] = (_signed(tk.keys[row]).clone(),
                          tk.estimates[row].clone(), tk.filled[row].clone())
        out[n] = st
    return out


# ---- the traced slice's entries --------------------------------------------

ENTRIES = ("update_score_rows", "update_rows", "query_many")


class Entries:
    """While active, each of the program's entries in ENTRIES runs inside
    `torch.profiler.record_function("pb.<entry>")`, and each call's
    inputs are kept (`calls[entry]`) for the work the reader counts; a
    read's probes are the host batch the benchmark handed (`probes`)."""

    def __init__(self):
        self.probes = None
        self._saved = {}
        self.clear()

    def clear(self) -> None:
        self.calls = {e: [] for e in ENTRIES}

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            with torch.profiler.record_function(f"pb.{name}"):
                out = fn(*args, **kw)
            self.calls[name].append(_inputs(name, args, kw, self.probes))
            return out
        return wrapped

    @contextlib.contextmanager
    def active(self):
        for e in ENTRIES:
            fn = getattr(ops, e, None)
            if fn is not None:
                self._saved[e] = fn
                setattr(ops, e, self._wrap(e, fn))
        try:
            yield self
        finally:
            for e, fn in self._saved.items():
                setattr(ops, e, fn)
            self._saved.clear()


def _geometry(spec: SketchSpec) -> dict:
    return {"width": spec.width, "depth": spec.depth, "seed": spec.seed,
            "bits": spec.counter.bits}


def _inputs(name, args, kw, probes) -> dict:
    def arg(i, key):
        return args[i] if len(args) > i else kw.get(key)
    tables, spec = args[0], args[1]
    if name == "query_many":
        return {"tenants": int(tables.shape[0]), "probes": probes,
                "geometry": _geometry(spec)}
    keys = arg(2, "keys")
    weights = kw.get("weights")
    rec = {"keys": keys, "weights": weights, "geometry": _geometry(spec),
           "rows": np.asarray(arg(4, "rows"), np.int64).reshape(-1)}
    if name == "update_score_rows":
        rec["cand"] = arg(5, "cand")
    return rec


# ---- faults the check must catch -------------------------------------------

FAULTS = ("stale_state", "half_batch", "altered_answer")


@contextlib.contextmanager
def planted(fault):
    """Run the program with one fault planted: a flush that returns its
    state unchanged, half of every batch left out, or one answer (one
    cell of each update, one estimate of each read) altered where it is
    produced."""
    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if fault == "stale_state":
        usr = ops.update_score_rows

        def stale_score(tables, *a, **kw):
            _, est = usr(tables.clone(), *a, **kw)
            return tables, est
        patch(ops, "update_score_rows", stale_score)
        patch(ops, "update_rows", lambda tables, *a, **kw: tables)
    elif fault == "half_batch":
        em = CountService.enqueue_many

        def half(self, events, ts=None):
            return em(self, {k: np.asarray(v)[:np.asarray(v).size // 2]
                             for k, v in events.items()}, ts=ts)
        patch(CountService, "enqueue_many", half)
    elif fault == "altered_answer":
        usr, ur, qm = ops.update_score_rows, ops.update_rows, ops.query_many

        def bump(tables, rows):
            r = int(np.asarray(rows).reshape(-1)[0])
            _signed(tables)[r, 0, 0] += 1

        def alt_score(tables, spec, keys, rng, rows, *a, **kw):
            out = usr(tables, spec, keys, rng, rows, *a, **kw)
            bump(out[0], rows)
            return out

        def alt_rows(tables, spec, keys, rng, rows, *a, **kw):
            out = ur(tables, spec, keys, rng, rows, *a, **kw)
            bump(out, rows)
            return out

        def alt_query(*a, **kw):
            out = qm(*a, **kw)
            out[0, 0] += 1.0
            return out
        patch(ops, "update_score_rows", alt_score)
        patch(ops, "update_rows", alt_rows)
        patch(ops, "query_many", alt_query)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
