"""Time the flush's update kernels and ops of one source tree.

    python3 tools/time_flush_kernels.py --src path/to/src --label change-1

Builds the CUDA kernels of the tree under `--src` (its
`repro_torch/kernels/csrc`) and times, at `chip_smoke.py`'s full sizes:

  * the tracked flush, `ops.update_score_rows` on 64 CMLS16 tenants x 4
    MiB (width 1,048,576, depth 2): 65,536 raw Zipf events a tenant
    (serve_counts' traffic, as `chip_smoke.py`'s kernel phase draws it),
    candidates the 64-key heap and the batch (M = 65,600): kernel 2;
  * the untracked all-active flush, `ops.update_many` on the same tables
    and events: kernel 5;
  * `fused_update_rows` on the window flush's last flush (32 windowed
    CMLS16 tenants x 8 buckets x 4 MiB, 32 x 16,384 sorted keys): kernel
    6; and `window_query_stacked_rows` on the tracker refresh's 32 x
    16,448 candidates, sorted and in ring order: kernel 9;
  * one tracked and one untracked epoch of the service (8 x
    `enqueue_many` of 64 x 8,192 events, then `flush`) under
    torch.profiler: wall, device busy, idle share, `cudaLaunchKernel`,
    `cudaMemcpyAsync` and `cudaStreamSynchronize` counts, and the device
    time by kernel.

For each op and kernel:

  * wrapper_ms -- CUDA events around one call (mean);
  * host_us -- host time of one call, launch included (mean);
  * device_ms -- torch.profiler's device time of one call, every kernel
    and copy it issues (the ops: dedup, draw and kernel);
  * kernel_alone_ms -- torch.profiler's device duration of the update
    kernels of one call, summed over its launches (a tree's kernel 2 may
    be one CUDA kernel or two).

Only public signatures that both trees share are used (the ops, and the
kernel 6 and 9 wrappers), so the same script times a parent tree and a
change in one call: run it against each tree's `src/` in turn, in the
order parent, change, change, parent.  Prints one JSON line with the
card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
TENANTS = 64
RING = 65_536
MICRO = 8
BATCH = RING // MICRO
WINDOW_TENANTS = 32
BUCKETS = 8
TRACK_TOP = 64
PROBES = 1024
BUDGET = 4_194_304
# the update kernels' profiler names in either tree (substrings)
UPDATE_KERNELS = ("fused_update_score_kernel", "fused_update_draw_kernel",
                  "fused_score_kernel")
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync",
                 "cudaStreamSynchronize")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, setup=None) -> float:
    total = 0.0
    for _ in range(reps + 1):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) if _ else 0.0  # first: warm-up
    return total / reps


def host_us(fn, reps: int, setup=None) -> float:
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e6


def device_rows(fn, reps: int, setup=None):
    """{kernel or copy name: (device ms, count)} over `reps` calls under
    torch.profiler (after one warm-up); `setup` runs before each call and
    its device-to-device copies are left out.  A session that recorded
    no device event is run again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if setup:
                    setup()
                fn()
            torch.cuda.synchronize()
        rows = {ev.key: (ev.self_device_time_total / 1e3, ev.count)
                for ev in prof.key_averages()
                if ev.device_type != torch.autograd.DeviceType.CPU
                and "DtoD" not in ev.key}
        if rows:
            return rows
    raise RuntimeError("profiler recorded no device event")


def kernel_alone_ms(rows: dict, names, reps: int) -> float:
    """Device ms of one call's kernels named by `names`: for each, the
    mean duration of its launches times its launches a call, summed."""
    total, seen = 0.0, 0
    for key, (ms, count) in rows.items():
        if any(n in key for n in names):
            total += ms / count * max(1, round(count / reps))
            seen += 1
    if not seen:
        raise RuntimeError(f"profiler saw none of {names}")
    return total


def timed(fn, reps: int, names, setup=None) -> dict:
    out = dict(wrapper_ms=event_ms(fn, reps, setup),
               host_us=host_us(fn, reps, setup))
    rows = device_rows(fn, reps, setup)
    out["device_ms"] = sum(ms for ms, _ in rows.values()) / reps
    out["kernel_alone_ms"] = kernel_alone_ms(rows, names, reps)
    return out


def profile_epoch(drive) -> dict:
    """One epoch under torch.profiler: wall, device busy, idle share,
    runtime calls counted, the device's top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev, calls = [], dict.fromkeys(RUNTIME_CALLS, 0)
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            if ev.key in calls:
                calls[ev.key] += ev.count
        else:
            dev.append((ev.key[:80], ev.self_device_time_total / 1e3,
                        ev.count))
    dev.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in dev)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall, "runtime_calls": calls,
            "device_top": [{"name": k, "ms": ms, "count": c}
                           for k, ms, c in dev[:12]]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="a tree's src/ directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core import prng
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import (CMLS16, from_numpy, signed_view,
                                           zeros)
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    from repro_torch.stream import window as w

    build.load()
    dev = torch.device("cuda")
    spec = sk.SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16)
    kw = dict(seeds=ops._seeds_tuple(spec), width=spec.width,
              counter=spec.counter, cpl=spec.cells_per_lane)
    out = {"label": args.label, "src": args.src, "card": card()}

    # kernels 2 and 5 through the ops, at the tracked flush's shape
    rng = np.random.default_rng(SEED)  # chip_smoke's kernel phase
    epochs = []
    for _ in range(2):
        many, _ = sc.make_epoch(rng, TENANTS, MICRO, BATCH)
        epochs.append(from_numpy(np.stack([
            np.concatenate([m[f"tenant_{t:02d}"] for m in many])
            for t in range(TENANTS)]), dev))
    tables = zeros((TENANTS, 2, spec.storage_width), spec.storage_dtype,
                   dev)
    rows = np.arange(TENANTS, dtype=np.int32)
    heap = torch.zeros((TENANTS, TRACK_TOP), dtype=torch.int32, device=dev)
    ops.update_score_rows(tables, spec, epochs[0], [SEED, 0], rows,
                          torch.cat([heap, signed_view(epochs[0])], dim=1)
                          .view(torch.uint32))
    raw = epochs[1]
    cand = torch.cat([signed_view(epochs[0][:, :TRACK_TOP]),
                      signed_view(raw)], dim=1).view(torch.uint32)
    before = tables.clone()
    live = int((sk.dedup_weighted(raw, torch.ones(
        raw.shape, dtype=torch.float32, device=dev))[1] > 0).sum())
    out["shape"] = {"tables": list(tables.shape), "keys": list(raw.shape),
                    "cand": list(cand.shape), "live": live}

    def reset():
        tables.copy_(before)

    def tracked():
        ops.update_score_rows(tables, spec, raw, [SEED, 1], rows, cand)

    def untracked():
        ops.update_many(tables, spec, raw, [SEED, 1])

    out["update_score_rows"] = timed(tracked, args.reps, UPDATE_KERNELS,
                                     setup=reset)
    out["update_many"] = timed(untracked, args.reps, UPDATE_KERNELS,
                               setup=reset)
    del before

    # kernels 6 and 9 on the window flush and the tracker refresh
    leaf = zeros((WINDOW_TENANTS, BUCKETS, 2, spec.storage_width),
                 spec.storage_dtype, dev)
    flat = leaf.view((-1,) + tuple(leaf.shape[2:]))
    rng = np.random.default_rng(SEED + 3)  # chip_smoke's kernel phase
    for i, c in enumerate((0, 3, 5)):
        pairs, _ = sc.make_trending(rng, WINDOW_TENANTS, 2, BATCH, 0.0)
        keys = from_numpy(np.stack([
            np.concatenate([ev[n] for ev, _ in pairs])
            for n in sc.trending_names(WINDOW_TENANTS)]), dev)
        skeys, mult = sk.dedup_weighted(
            keys, torch.ones(keys.shape, dtype=torch.float32, device=dev))
        unif = prng.uniform_rows([SEED, 100 + i], WINDOW_TENANTS,
                                 keys.shape[1], np.arange(WINDOW_TENANTS),
                                 device=dev)
        wrows = np.arange(WINDOW_TENANTS) * BUCKETS + c
        keys_u = ops.as_device_keys(skeys, dev)
        if c == 5:
            fbefore = flat.clone()
            last = (keys_u, mult, unif, wrows)
            ring_order = keys
        ksk.fused_update_rows(flat, keys_u, mult, unif, wrows, **kw)
    torch.cuda.synchronize()
    probes = from_numpy(sc.probes_for(0, PROBES, WINDOW_TENANTS)[2:], dev)
    wcand = torch.cat([signed_view(probes[:, :TRACK_TOP]),
                       signed_view(last[0])], dim=1).view(torch.uint32)
    wcand_ring = torch.cat([signed_view(probes[:, :TRACK_TOP]),
                            signed_view(ring_order)], dim=1).view(
                                torch.uint32)
    refresh = np.arange(WINDOW_TENANTS)[::-1].copy()
    wts = w.window_weights_stacked(np.full(WINDOW_TENANTS, 5), BUCKETS,
                                   device=dev)[refresh].contiguous()
    work = flat.clone()

    def reset_flat():
        work.copy_(fbefore)

    def update_rows():
        ksk.fused_update_rows(work, *last, **kw)

    def query(keys=wcand):
        ksk.window_query_stacked_rows(leaf, keys, wts, refresh, **kw)

    out["fused_update_rows"] = timed(update_rows, args.reps,
                                     ("fused_update_rows_kernel",),
                                     setup=reset_flat)
    out["window_query_stacked_rows"] = timed(query, args.reps,
                                             ("window_query_rows_kernel",))
    out["window_query_stacked_rows_ring_order"] = timed(
        lambda: query(wcand_ring), args.reps, ("window_query_rows_kernel",))
    del leaf, flat, work, fbefore, tables

    # one tracked and one untracked service epoch under the profiler
    erng = np.random.default_rng(SEED + 1)
    for name, top in (("tracked_epoch", TRACK_TOP),
                      ("untracked_epoch", None)):
        svc = sc.build_service(spec, TENANTS, RING, SEED, top, device=dev)
        warm, prof = (sc.make_epoch(erng, TENANTS, MICRO, BATCH)[0]
                      for _ in range(2))

        def drive(many):
            for events in many:
                svc.enqueue_many(events)
            svc.flush()
        drive(warm)
        out[name] = profile_epoch(lambda: drive(prof))
        del svc
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
