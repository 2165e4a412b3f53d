"""A traced slice: torch.profiler over a run of units, read into numbers.

Busy and idle are the port's `chip_smoke.profile_epoch` arithmetic
(copied; no code path shares it): the device is busy while an operation
of it runs (kernels, copies, fills; the intervals merged), idle the rest
of the slice's wall time, which ends at a synchronize.  Runtime calls
(`cudaLaunchKernel`, ...) are counted from the host side of the trace.
A range the benchmark opened (`pb.<name>`) reads the device time of
every kernel launched inside it.  Idle gaps are labelled by the
innermost host operation that was running at the gap's middle (or
`host` when none was), and summed by label.
"""
from __future__ import annotations

import bisect
import collections
import time

import torch

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
# every runtime call that puts an operation on the device
RUNTIME_LAUNCHES = LAUNCHES + ("cudaMemcpyAsync", "cudaMemsetAsync",
                               "cudaMemcpy", "cudaMemset",
                               "cudaGraphLaunch")
TOP = 10


def profile(drive, units: int, sync) -> tuple:
    """(profiler, wall seconds) of drive(i) for i in range(units)."""
    from torch.profiler import ProfilerActivity, profile as prof_
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with prof_(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            drive(i)
        sync()
        wall = time.perf_counter() - t0
    return prof, wall


def read(prof, wall: float) -> dict:
    """busy_s, window_s, launches, {range: device seconds and calls},
    device_ops and idle_gaps (each at most TOP entries), from the raw
    events of the trace.  A range's device time is that of the device
    operations whose launches (matched by correlation id) the host made
    inside the range, on the range's thread."""
    host, dev, launch = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(e)
            if e.name() in RUNTIME_LAUNCHES:
                launch[e.correlation_id()] = e
        else:
            dev.append(e)
    dev = [e for e in dev if not e.is_user_annotation()
           and not e.name().startswith("pb.")]
    merged = []
    for a, b in sorted((e.start_ns(), e.end_ns()) for e in dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    by_op = collections.Counter()
    for e in dev:
        by_op[e.name()] += e.end_ns() - e.start_ns()
    ranges = {}
    opened = [e for e in host if e.name().startswith("pb.")]
    for r in opened:
        ranges.setdefault(r.name()[3:], {"device_s": 0.0, "calls": 0})
        ranges[r.name()[3:]]["calls"] += 1
    for e in dev:
        src = launch.get(e.correlation_id())
        if src is None:
            continue
        for r in opened:
            if (r.start_thread_id() == src.start_thread_id()
                    and r.start_ns() <= src.start_ns() <= r.end_ns()):
                ranges[r.name()[3:]]["device_s"] += \
                    (e.end_ns() - e.start_ns()) / 1e9
                break
    launches = sum(e.name() in LAUNCHES for e in host)
    return {"busy_s": sum(b - a for a, b in merged) / 1e9, "window_s": wall,
            "launches": launches, "ranges": ranges,
            "device_ops": [[n[:120], ns / 1e9]
                           for n, ns in by_op.most_common(TOP)],
            "idle_gaps": _gaps(merged, host)}


def _gaps(merged, host) -> list:
    """Idle time between device intervals, summed by the innermost host
    operation open at each gap's middle."""
    if not merged:
        return []
    host = sorted(host, key=lambda e: e.start_ns())
    starts = [e.start_ns() for e in host]
    by_label = collections.Counter()
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        best = None
        for e in host[max(0, i - 400):i]:
            if e.end_ns() >= mid and (best is None or e.duration_ns()
                                      < best.duration_ns()):
                best = e
        by_label["host" if best is None else best.name()[:120]] += b - a
    return [[n, ns / 1e9] for n, ns in by_label.most_common(TOP)]
