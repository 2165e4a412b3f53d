"""Time the window flush's two row-mapped kernels of one source tree.

    python3 tools/time_flush_kernels.py --src path/to/src --label change-1

Builds the CUDA kernels of the tree under `--src` (its
`repro_torch/kernels/csrc`), makes the inputs of `chip_smoke.py`'s
kernel phase at full size (32 windowed CMLS16 tenants x 8 buckets x 4 MiB;
three window flushes of serve_counts' Zipf traffic, 32 x 16,384 sorted
keys each; then the tracker refresh's 32 x 16,448 candidates), and times
`fused_update_rows` on the last flush and `window_query_stacked_rows` on
the refresh, its candidates in two orders: the 64 heap keys and the last
flush's keys sorted (`chip_smoke.py`'s shape), and the same keys as the
service passes them, the batch as it sits in the ring.  Three times
each:

  * wrapper_ms -- CUDA events around one wrapper call (mean);
  * host_us -- host time of one wrapper call, launch included (mean);
  * kernel_alone_ms -- torch.profiler's device duration of the kernel
    (mean over the launches it recorded), taken after the other two.

Only the wrappers' public signatures are used, so the same script times a
parent tree and a change in one call: run it against each tree's `src/`
in turn, in the order parent, change, change, parent.  Prints one JSON
line with the card's name and power limit (nvidia-smi).
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
TENANTS = 32
BUCKETS = 8
BATCH = 8192
TRACK_TOP = 64
PROBES = 1024
BUDGET = 4_194_304


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


def kernel_alone_ms(fn, reps: int, name: str, setup=None) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if setup:
                    setup()
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if (ev.device_type != torch.autograd.DeviceType.CPU
                    and name in ev.key):
                total += ev.self_device_time_total / 1e3
                count += ev.count
        if count:
            break
    if not 0 < count <= reps:
        raise RuntimeError(f"profiler saw {count} {name!r} launches")
    return total / count


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
    leaf = zeros((TENANTS, BUCKETS, 2, spec.storage_width),
                 spec.storage_dtype, dev)
    flat = leaf.view((-1,) + tuple(leaf.shape[2:]))
    rng = np.random.default_rng(SEED + 3)  # chip_smoke's kernel phase
    for i, c in enumerate((0, 3, 5)):
        pairs, _ = sc.make_trending(rng, TENANTS, 2, BATCH, 0.0)
        raw = np.stack([np.concatenate([ev[n] for ev, _ in pairs])
                        for n in sc.trending_names(TENANTS)])
        keys = from_numpy(raw, dev)
        skeys, mult = sk.dedup_weighted(
            keys, torch.ones(keys.shape, dtype=torch.float32, device=dev))
        unif = prng.uniform_rows([SEED, 100 + i], TENANTS, keys.shape[1],
                                 np.arange(TENANTS), device=dev)
        rows = np.arange(TENANTS) * BUCKETS + c
        keys_u = ops.as_device_keys(skeys, dev)
        if c == 5:
            before = flat.clone()
            last = (keys_u, mult, unif, rows)
            ring_order = keys
        ksk.fused_update_rows(flat, keys_u, mult, unif, rows, **kw)
    torch.cuda.synchronize()
    probes = from_numpy(sc.probes_for(0, PROBES, TENANTS)[2:], dev)
    cand = torch.cat([signed_view(probes[:, :TRACK_TOP]),
                      signed_view(last[0])], dim=1).view(torch.uint32)
    cand_ring = torch.cat([signed_view(probes[:, :TRACK_TOP]),
                           signed_view(ring_order)], dim=1).view(torch.uint32)
    refresh_rows = np.arange(TENANTS)[::-1].copy()
    wts = w.window_weights_stacked(np.full(TENANTS, 5), BUCKETS,
                                   device=dev)[refresh_rows].contiguous()
    work = flat.clone()

    def reset():
        work.copy_(before)

    def update():
        ksk.fused_update_rows(work, *last, **kw)

    def query(keys=cand):
        ksk.window_query_stacked_rows(leaf, keys, wts, refresh_rows, **kw)

    def query_ring():
        query(cand_ring)

    out = {"label": args.label, "src": args.src, "card": card()}
    out["fused_update_rows"] = dict(
        wrapper_ms=event_ms(update, args.reps, setup=reset),
        host_us=host_us(update, args.reps, setup=reset))
    out["window_query_stacked_rows"] = dict(
        wrapper_ms=event_ms(query, args.reps),
        host_us=host_us(query, args.reps))
    out["window_query_stacked_rows_ring_order"] = dict(
        wrapper_ms=event_ms(query_ring, args.reps),
        host_us=host_us(query_ring, args.reps))
    out["fused_update_rows"]["kernel_alone_ms"] = kernel_alone_ms(
        update, args.reps, "fused_update", setup=reset)
    for name, fn in (("window_query_stacked_rows", query),
                     ("window_query_stacked_rows_ring_order", query_ring)):
        out[name]["kernel_alone_ms"] = kernel_alone_ms(fn, args.reps,
                                                       "window_query")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
