"""What decides `correct`: the program's outputs against the reference.

The run copies, at units drawn from the seed, the state of a few tenants
drawn from the seed: before the unit (the program's own state, which
the reference starts from) and after it (what the unit produced: the
ring the appends wrote, the tables or window ring the flushes and
rotations left, the heap, and a read's answers).  The first unit of the
run is checked from the empty state the reference makes itself, so
the start needs nothing of the program's.  The reference
(`reference/planes.py`) follows every plane's bookkeeping from the
start of the run (fills, flush numbers, watermarks, cursors), and
recomputes the checked tenants' units from the inputs the benchmark
handed the service.  Every number compared is a count of entries apart,
and its limit is 0: the configuration promises the sketch's own answers,
bit for bit.

The control is the reference put in the program's place with one of the
configuration's guarantees broken: the last microbatch of each checked
unit is left out for the checked tenants (an event not landed; for a
read, a read that misses the writes before it).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from reference import planes as rp
from reference import sketch as rs

NUMBERS = ("ring_apart", "cells_apart", "heap_apart")
READ_NUMBERS = NUMBERS + ("answers_apart",)
LANES = 128


def _i64(t: torch.Tensor, bits: int) -> torch.Tensor:
    return t.to(torch.int64) & ((1 << bits) - 1)


def geometry(s: dict) -> rs.Geometry:
    c = s["counter"]
    return rs.Geometry(width=s["width"], depth=s["depth"], seed=s["seed"],
                       counter=rs.Counter(c["kind"], c["base"], c["bits"]))


def ring_width(capacity: int) -> int:
    return max(LANES, LANES * -(-int(capacity) // LANES))


class Model:
    """The reference's service: the config's planes, and the plan's
    calls replayed on them unit by unit."""

    def __init__(self, config: dict, seed: int, names):
        capw = ring_width(config["queue_capacity"])
        win = config.get("window")
        self.main = rp.Plane(
            names, geometry(config["sketch"]), seed, capw,
            config["track_top"],
            None if win is None else (win["buckets"], win["interval_s"]))
        mp = config["metrics_plane"]
        self.metrics = rp.Plane(mp["tenants"], geometry(mp["sketch"]), seed,
                                capw, config["track_top"])

    def plane(self, name: str) -> rp.Plane:
        return self.main if name in self.main.row else self.metrics

    def unit(self, micro, drop_last=frozenset()) -> None:
        """Replay one unit's calls: its microbatches' appends (a windowed
        plane's watermark first), then the flush every unit ends with (a
        read's read-your-writes flush, or an epoch's flush).  Tenants in
        `drop_last` lose the last microbatch (the control)."""
        for j, (ev, met, ts) in enumerate(micro):
            last = j == len(micro) - 1
            for n, k in (met or {}).items():
                self.metrics.append(n, k, land=not (last and n in drop_last))
            if ts is not None:
                self.main.advance(list(ev), ts)
            for n, k in ev.items():
                self.main.append(n, k, land=not (last and n in drop_last))
        self.main.flush()
        self.metrics.flush()

    def load(self, name: str, snap: dict | None) -> None:
        """Start tenant `name`'s arithmetic from the program's state
        `snap`, or from the empty state (None)."""
        p = self.plane(name)
        g = p.geo
        if snap is None:
            lead = (1,) if p.window is None else (p.window[0],)
            cells = torch.zeros(lead + (g.depth, g.width), dtype=torch.int64)
            ring = torch.zeros(p.capw, dtype=torch.int64)
            heap = None
            if p.track_top:
                k = p.track_top
                heap = (torch.zeros(k, dtype=torch.int64),
                        torch.full((k,), -torch.inf),
                        torch.zeros(k, dtype=torch.bool))
        else:
            cells = _i64(snap["cells"], g.counter.bits)
            if p.window is None:
                cells = cells[None]
            ring = _i64(snap["ring"], 32)
            heap = None
            if "heap" in snap:
                hk, he, hf = snap["heap"]
                heap = (_i64(hk, 32), he.clone(), hf.clone())
        p.states[p.row[name]] = rp.TenantState(cells, ring, heap)


def _apart(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


def _float_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    a, b = a.to(torch.float32), b.to(torch.float32)
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def compare_state(model: Model, name: str, post: dict) -> dict:
    """Entries apart between the program's post-unit state `post` and
    the reference's state of tenant `name`."""
    p = model.plane(name)
    st = p.states[p.row[name]]
    cells = _i64(post["cells"], p.geo.counter.bits)
    if p.window is None:
        cells = cells[None]
    out = {"ring_apart": _apart(_i64(post["ring"], 32), st.ring),
           "cells_apart": _apart(cells, st.cells), "heap_apart": 0}
    if st.heap is not None:
        hk, he, hf = post["heap"]
        rk, re_, rf = st.heap
        hk = _i64(hk, 32)
        differ = ((hk != rk) & (hf | rf)) | (hf != rf) \
            | (he.view(torch.int32) != re_.view(torch.int32))
        out["heap_apart"] = int(differ.sum())
    return out


def run_check(config: dict, seed: int, plan, names, record: dict,
              control: bool = False) -> dict:
    """The numbers compared, summed over the checked units and tenants.

    record: {"tenants": [...], "units": {u: {"pre": snap or None,
    "post": snap, "answers": {tenant: (N,) host tensor} or absent}}},
    every tensor on the host.  With `control`, the reference with the
    last microbatch of each checked unit left out stands in for the
    program.  The reference runs on the host: its bookkeeping through
    the whole run, each checked unit's arithmetic on a copy of it from
    the unit's start."""
    tenants = record["tenants"]
    units = record["units"]
    model = Model(config, seed, names)
    total = dict.fromkeys(READ_NUMBERS if plan.probes(0) is not None
                          else NUMBERS, 0)
    for u in range(max(units) + 1):
        micro = plan.microbatches(u)
        got = units.get(u)
        if got is not None:
            job = copy.deepcopy(model)
            for n in tenants:
                job.load(n, got["pre"][n] if got["pre"] else None)
            for k, v in _unit_job(job, micro, got, tenants, plan.probes(u),
                                  control).items():
                total[k] += v
        model.unit(micro)
    return total


def _unit_job(model: Model, micro, got: dict, tenants, probes,
              control: bool) -> dict:
    """One checked unit: the reference (and the control) replay it from
    its start, and what the program (or the control) produced is
    compared entry by entry."""
    out = dict.fromkeys(NUMBERS if probes is None else READ_NUMBERS, 0)
    with torch.inference_mode():
        ctrl = copy.deepcopy(model) if control else None
        model.unit(micro)
        if ctrl is not None:
            ctrl.unit(micro, drop_last=frozenset(tenants))
            posts = {n: _model_snap(ctrl, n) for n in tenants}
            answers = ({n: _model_answers(ctrl, n, probes) for n in tenants}
                       if probes is not None else {})
        else:
            posts = got["post"]
            answers = got.get("answers", {})
        for n in tenants:
            for k, v in compare_state(model, n, posts[n]).items():
                out[k] += v
            if probes is not None:
                out["answers_apart"] += _float_apart(
                    answers[n], _model_answers(model, n, probes))
    return out


def _model_answers(model: Model, name: str, probes) -> torch.Tensor:
    p = model.plane(name)
    return p.answers(p.row[name], torch.as_tensor(probes.astype(np.int64)))


def _model_snap(model: Model, name: str) -> dict:
    """The control's post-unit state in the form of a program snapshot."""
    p = model.plane(name)
    st = p.states[p.row[name]]
    out = {"cells": st.cells[0] if p.window is None else st.cells,
           "ring": st.ring}
    if st.heap is not None:
        out["heap"] = st.heap
    return out
