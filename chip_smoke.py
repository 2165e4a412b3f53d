"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, main path, times.

    python3 chip_smoke.py

Imports nothing of JAX or of the JAX package `repro`; it drives the port
(`src/repro_torch`) only.  Phases, each of which fails the run (non-zero
exit, no result line) if anything disagrees:

  1. build   -- compile the hand-written CUDA kernels from
                `src/repro_torch/kernels/csrc/` (nvcc, sm_90a) and print
                the build seconds;
  2. kernels -- every kernel against its plain PyTorch version on the
                card, at the main path's full-size shapes: fused_query and
                fused_update_score across all five storage formats
                (CMS32, CMLS16, CMLS16 packed, CMLS8, CMLS8 packed, each
                64 tenants x 4 MiB; the kernel draws its uniforms from
                the flush key, the plain version is fed
                `prng.uniform_rows` of the same key and grid, so equal
                states prove the draw bit for bit), the two ring appends
                on 65,536-key
                rings with 8,192-key batches, aligned and at the edge
                cases (a call of MAX_APPEND_ROWS + 37 rows split over two
                launches, odd fill offsets, zero counts, rows ending at
                capw).  Equality is exact: states, ring cells and
                estimates;
  3. main    -- the counting service at full size (64 CMLS16 tenants of
                4 MiB, width 1,048,576, depth 2; a 65,536-key ring per
                tenant; track_top=64; plus the CMS32 metrics plane),
                driven through `enqueue_many`, `enqueue` (one queue-
                pressure flush), `flush`, `query_all`, `query`, `topk`
                with engine="auto".  The kernel launch counts are set to
                0 just before and read just after: every kernel must have
                launched.  The dispatch audit must show one
                update_score_rows per fill class per flush and no update
                dispatch on a clean read.  The same stream then runs with
                engine="plain" on the card; tables, rings, fills, trackers
                and answers must be equal;
  4. times   -- CUDA-event times and wrapper host times of each kernel,
                its plain version and, where one exists, a single PyTorch
                call computing the same function, and for the appends the
                wrapper's host time by part; the end-to-end ingest rate
                and the query_all latency;
  5. kernels 5-9 -- fused_update, fused_update_rows and the three window
                queries against their plain versions on the card, at the
                full-size shapes of the paths below, all five storage
                formats, both window modes, exact; then the edge cases of
                the two row-mapped kernels at full width in every format:
                fused_update_rows on a call of MAX_MAPPED_ROWS + 37 rows
                (two launches), one row, every key distinct, one key,
                keys 0 and 0xFFFFFFFF, mult == 0 everywhere and (CMLS8)
                states 246-255 at u = 0; window_query_stacked_rows on a
                split call, one ring, one key, 16,448 distinct keys a
                ring, keys 0 and 0xFFFFFFFF, both modes, three weight
                sets; and the edge cases of the two drawn updates,
                fused_update_score and fused_update, at full width in
                every format (DRAWN_EDGES: 65,536 distinct keys a row,
                one key, empty leading chunks, N < 1024, N not a multiple
                of 1024, one row, depth 4, M not a multiple of the score
                tile, a draw index with a nonzero high word); and the
                edge cases of the two lane kernels, window_query and
                window_query_stacked, on the full-width leaf in every
                format and both modes (LANE_EDGES: a zero weight at
                bucket 0, every weight zero, the n_buckets masks 1-8,
                (N,) probes shared by every ring (ring stride 0), N = 1,
                N not a multiple of the tile, 300,000 keys a ring, keys 0
                and 0xFFFFFFFF, repeated keys);
  6. paths   -- the windowed service (32 windowed CMLS16 tenants x 8
                buckets of 60 s, a 1 GiB leaf, track_top=64, beside the
                CMS32 metrics plane) through 12 epochs of serve_counts'
                event-time stream (rotations by one interval, several,
                and a full clear, each with pending fill), then flush,
                query_all, query (n_buckets, max, gamma) and topk; and the
                64 CMLS16 tenants without tracking (one all-active epoch,
                one skewed epoch of two fill classes).  Each path runs with
                its launch counts set to 0 just before and read just
                after, its dispatch audit checked, then again on the plain
                engine: leaves, cursors, watermarks, rings, fills,
                trackers and answers must be equal;
  7. times   -- CUDA-event times of kernels 5-9 beside their plain
                versions and bytes bounds; the windowed ingest rate, and
                the query_all and one-tenant query latencies, with
                kernels and with the plain engine;
  8. sync    -- 8 full-size `enqueue_many` calls on a fresh tracked and a
                fresh windowed service under
                torch.cuda.set_sync_debug_mode("error") (rings filled
                exactly, event times inside one interval: no flush, no
                rotation); then, on two more fresh services and in the
                same mode, a tracked flush, window flushes of one and of
                two fill classes and a windowed enqueue_many(ts=) that
                flushes and rotates; a synchronizing call fails the run;
                tables, leaves, cursors, rings, fills and trackers must
                equal the plain engine's; then, in the same mode, the
                windowed service's reads: `query` (full window,
                n_buckets=2, gamma=0.9, mode="max") and `query_all`
                (shared and per-tenant probes), each equal to a copy of
                the service on the plain engine;
  9. profiles -- last, since a torch.profiler session slows the process's
                later host work: one tracked and one windowed epoch
                (device busy and idle share, synchronizes and copies
                counted), every kernel's time alone (its profiler
                duration), the card's random-read floor of kernels 7-9
                (each distinct word a call reads, read once in random
                order by one index kernel: tools/time_read_kernels.py),
                then the append wrappers' host time again.

Prints the card's name and power limit, one {"kernels": [...]} line, and
as its last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SECTOR = 32                 # bytes a random device-memory access moves
DRAW_OPS = 85               # integer operations of one in-kernel uniform:
                            # 20 threefry rounds (add, rotate, xor), key
                            # injections, the float step, the index
TENANTS = 64
BUDGET = 4_194_304          # bytes per tenant table (configs/paper_sketch.py)
RING = 65_536
TRACK_TOP = 64
MICRO = 8
BATCH = RING // MICRO       # events per tenant per microbatch
PROBES = 1024
SEED = 0
WINDOW_TENANTS = 32         # trending_00..31, WindowSpec(CMLS16, 8, 60 s)
WINDOW_BUCKETS = 8
WINDOW_EPOCHS = 12
OUTAGE_EPOCH = 6            # event time jumps OUTAGE seconds before it
OUTAGE = 600.0              # ten intervals: more than the 8-bucket ring
# host-side CUDA runtime calls counted over each profiled epoch
RUNTIME_CALLS = ("cudaStreamSynchronize", "cudaMemcpyAsync",
                 "cudaLaunchKernel", "cudaEventSynchronize")


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean milliseconds of fn() over `reps` launches, by CUDA events
    (one warm-up first; `setup` runs untimed before each launch)."""
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def timed(fn, reps: int, setup=None) -> dict:
    """A kernel wrapper's times: "ms", CUDA events around one call
    (`cuda_ms`), and "host_us", the host time of one call in us
    (perf_counter around it, the card idle before it); "timed" keeps fn
    and setup for the kernel-alone profile of phase 9."""
    ms = cuda_ms(fn, reps, setup)
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"ms": ms, "host_us": total / reps * 1e6,
            "timed": (fn, setup, reps)}


def profile_epoch(drive) -> dict:
    """Device time by kernel, and host time by op, over one ingest epoch
    (`drive()`: the microbatches' `enqueue_many` + `flush`), from
    torch.profiler; the device's idle share is 1 - busy / wall over the
    same window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_rows, host_rows = [], []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            # CPU-side ops also carry their children's device time: count
            # device time only on the device's own events (kernels, copies)
            host_rows.append((ev.key, ev.self_cpu_time_total / 1e3,
                              ev.count))
        else:
            device_rows.append((ev.key, ev.self_device_time_total / 1e3,
                                ev.count))
    device_rows.sort(key=lambda r: -r[1])
    host_rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in device_rows)

    def top(rows):
        return [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:10]]
    calls = dict.fromkeys(RUNTIME_CALLS, 0)
    for key, _, count in host_rows:
        if key in calls:
            calls[key] += count
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3), "runtime_calls": calls,
            "device_top": top(device_rows), "host_top": top(host_rows)}


# the profiler's names of each wrapper's kernels (substrings of them):
# one call of fused_update_score is two CUDA kernels, the update and the
# candidate scores
KERNEL_NAMES = {
    "fused_query": ("fused_query_kernel",),
    "fused_update_score": ("fused_update_draw_kernel", "fused_score_kernel"),
    "queue_append": ("RowsMeta",),
    "queue_append_dense": ("DenseMeta",),
    "fused_update": ("fused_update_draw_kernel",),
    "fused_update_rows": ("fused_update_rows_kernel",),
    "window_query": ("window_query_kernel",),
    "window_query_stacked": ("window_query_kernel",),
    "window_query_stacked_rows": ("window_query_rows_kernel",),
}


def kernel_device_ms(fn, reps: int, names, setup=None) -> float:
    """Device ms of one call's kernels alone, without the host work around
    their launches: for each profiler name in `names` (a substring of a
    kernel's name), the mean duration of its launches over `reps` calls
    of fn() under torch.profiler (one warm-up first; `setup`, untimed by
    the name filter, before each call), summed over the names.  Each mean
    is over the launches the profiler recorded, which may miss one of a
    run; a session that recorded none of some name's launches is run
    again, up to three times."""
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
        seen = {name: [0.0, 0] for name in names}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CPU:
                continue
            for name in names:
                if name in ev.key:
                    seen[name][0] += ev.self_device_time_total / 1e3
                    seen[name][1] += ev.count
        if all(count for _, count in seen.values()):
            break
    for name, (_, count) in seen.items():
        if not 0 < count <= reps:
            fail(f"torch.profiler saw {count} launches of {name!r} in {reps} "
                 "calls")
    return sum(total / count for total, count in seen.values())


def append_host_us(dev, ring, calls: dict, reps: int = 2000) -> dict:
    """Where a ring-append wrapper's host time goes: the mean host time in
    us per call over `reps` back-to-back calls (perf_counter; the kernels
    queue behind) of the checks (`_append_meta`, which also builds the
    int64 meta the C entry points take), the current-stream lookup, the
    bare C launch with its meta prepared, and the whole wrapper; beside
    them the same for the `index_put_` yardstick.  `calls`: {kernel name:
    (keys, rows or None, fill, count, the index_put_ call)}."""
    from repro_torch.kernels import build
    from repro_torch.kernels import sketch as ksk
    lib = build.load()
    stream = ksk._stream(ring.device)

    def per_call_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6
    out = {}
    for name, (keys, rows, fill, count, library) in calls.items():
        dense = rows is None
        meta = ksk._append_meta(ring, keys, rows, fill, count)
        entry = getattr(lib, "cml_" + name)
        wrapper = getattr(ksk, name)
        args = (fill, count) if dense else (rows, fill, count)
        out[name] = {
            "checks_us": per_call_us(lambda: ksk._append_meta(
                ring, keys, rows, fill, count)),
            "stream_us": per_call_us(lambda: ksk._stream(ring.device)),
            "c_launch_us": per_call_us(lambda: entry(
                ring.data_ptr(), ring.shape[1], keys.data_ptr(),
                keys.shape[0], keys.shape[1], meta.ctypes.data, stream)),
            "wrapper_us": per_call_us(lambda: wrapper(ring, keys, *args)),
            "index_put_us": per_call_us(library)}
    return out


def append_param_block_us(dev, reps: int = 2000) -> dict:
    """Host time per bare dense-append launch (1 key a row, so the card
    keeps up) with the small parameter block (64 rows: 512 B of meta) and
    the large one (65 rows: 8 KB of meta, CML_APPEND_MAX_ROWS a launch)."""
    from repro_torch.core.counters import zeros
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import sketch as ksk
    lib = build.load()
    stream = ksk._stream(dev)
    capw = ops.ring_width(RING)
    out = {}
    for rows in (64, 65):
        ring = zeros((rows, capw), torch.uint32, dev)
        keys = zeros((rows, ops.CHUNK), torch.uint32, dev)
        meta = np.stack([np.zeros(rows), np.ones(rows)]).astype(np.int64)

        def launch():
            return lib.cml_queue_append_dense(
                ring.data_ptr(), capw, keys.data_ptr(), rows, ops.CHUNK,
                meta.ctypes.data, stream)
        launch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
        out[f"{rows}_rows_us"] = (time.perf_counter() - t0) / reps * 1e6
    return out


def sectors(spec, keys_i64, mask=None) -> int:
    """Distinct 32-byte sectors the keys' cells occupy, per table row."""
    from repro_torch.core.hashing import row_hashes
    from repro_torch.kernels import ops
    dev = keys_i64.device
    cols = row_hashes(keys_i64, ops._seed_tensor(spec, dev), spec.width)
    d, r, n = cols.shape                                       # (d, R, N)
    word_bytes = 4
    cells_per_word = 32 // spec.counter.bits
    sec = (cols // cells_per_word) * word_bytes // SECTOR
    rid = (torch.arange(r, device=dev)[None, :, None] * d
           + torch.arange(d, device=dev)[:, None, None])
    flat = rid * (1 << 40) + sec
    if mask is not None:
        flat = flat[:, mask]
    return int(torch.unique(flat).numel())


def summary(xs) -> dict:
    xs = np.sort(np.asarray(xs))
    out = {"n": int(xs.size), "median": float(np.median(xs)),
           "min": float(xs[0]), "max": float(xs[-1])}
    if xs.size >= 200:  # p95 with at least ten samples beyond it
        out["p95"] = float(np.percentile(xs, 95))
    return out


# ---- phases of the windowed and untracked paths (slice 2) ------------------

def i64(keys: torch.Tensor) -> torch.Tensor:
    """uint32 keys as int64 values."""
    return keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def window_flush_inputs(dev, rng, buckets):
    """Per bucket in `buckets`: one window flush's kernel inputs for the
    32 windowed tenants: two microbatches of serve_counts' Zipf traffic
    per tenant (what one 60 s interval gathers), deduplicated, and the
    flush's uniforms over the (32, N) tenant grid."""
    from repro_torch.core import prng
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import from_numpy
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_counts as sc
    out = []
    for i, c in enumerate(buckets):
        pairs, _ = sc.make_trending(rng, WINDOW_TENANTS, 2, BATCH, 0.0)
        raw = np.stack([np.concatenate([ev[n] for ev, _ in pairs])
                        for n in sc.trending_names(WINDOW_TENANTS)])
        keys = from_numpy(raw, dev)
        skeys, mult = sk.dedup_weighted(
            keys, torch.ones(keys.shape, dtype=torch.float32, device=dev))
        unif = prng.uniform_rows([SEED, 100 + i], WINDOW_TENANTS,
                                 keys.shape[1], np.arange(WINDOW_TENANTS),
                                 device=dev)
        rows = np.arange(WINDOW_TENANTS) * WINDOW_BUCKETS + c
        out.append(dict(skeys=skeys, keys=ops.as_device_keys(skeys, dev),
                        mult=mult, unif=unif, rows=rows))
    return out


def check_slice2_kernels(dev, formats, epoch_keys) -> tuple[dict, dict]:
    """Kernels 5-9 against their plain versions on the card, at the
    full-size shapes of the untracked and windowed paths, in every
    storage format: states and estimates bit for bit.  Returns (max abs
    error per kernel, CMLS16 inputs for the timings)."""
    from repro_torch.core import sketch as sk
    from repro_torch.core import prng
    from repro_torch.core.counters import from_numpy, signed_view, zeros
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    from repro_torch.stream import window as w
    rng = np.random.default_rng(SEED + 3)
    errs = dict.fromkeys(("fused_update_score", "fused_update",
                          "fused_update_rows", "window_query",
                          "window_query_stacked",
                          "window_query_stacked_rows"), 0.0)
    keep = {}
    keys = epoch_keys[0]
    skeys, mult = sk.dedup_weighted(
        keys, torch.ones(keys.shape, dtype=torch.float32, device=dev))
    skeys_u = ops.as_device_keys(skeys, dev)
    unif = prng.uniform_rows([SEED, 7], TENANTS, keys.shape[1],
                             np.arange(TENANTS), device=dev)
    flushes = window_flush_inputs(dev, rng, (0, 3, 5))
    probes = from_numpy(sc.probes_for(0, PROBES, WINDOW_TENANTS)[2:], dev)
    last = flushes[-1]
    cand = torch.cat([signed_view(probes[:, :TRACK_TOP]),
                      signed_view(last["keys"])], dim=1).view(torch.uint32)
    refresh_rows = np.arange(WINDOW_TENANTS)[::-1].copy()
    weight_sets = [
        ("full window", w.window_weights_stacked(
            np.full(WINDOW_TENANTS, 5), WINDOW_BUCKETS, device=dev)),
        ("n_buckets=3", w.window_weights_stacked(
            np.full(WINDOW_TENANTS, 5), WINDOW_BUCKETS, n_buckets=3,
            device=dev)),
        ("gamma=0.9", w.window_weights_stacked(
            np.arange(WINDOW_TENANTS) % WINDOW_BUCKETS, WINDOW_BUCKETS,
            gamma=0.9, device=dev)),
    ]

    def same(name, what, a, b):
        ok = torch.equal(signed_view(a), signed_view(b))
        err = 0.0
        if a.dtype == torch.float32:
            err = float((a - b).abs().max())
            errs[name] = max(errs[name], err)
        if not ok:
            fail(f"{name} {what} differs from its plain version (max abs "
                 f"{err})")

    for fname, counter, packed in formats:
        spec = sk.SketchSpec.from_memory(BUDGET, depth=2, counter=counter,
                                         packed=packed)
        kw = dict(seeds=ops._seeds_tuple(spec), width=spec.width,
                  counter=spec.counter, cpl=spec.cells_per_lane)
        seed_t = ops._seed_tensor(spec, dev)
        # kernel 5: the untracked all-active flush, 64 x 4 MiB
        tk = zeros((TENANTS, 2, spec.storage_width), spec.storage_dtype, dev)
        tp = tk.clone()
        ksk.fused_update(tk, skeys_u, mult, [SEED, 7], **kw)
        ref.fused_update_plain(tp, skeys, mult, unif, seed_t, spec.counter,
                               ksk.CHUNK, cpl=spec.cells_per_lane)
        torch.cuda.synchronize()
        same("fused_update", fname, tk, tp)
        if fname == "CMLS16":
            keep["update"] = dict(spec=spec, skeys=skeys, keys=skeys_u,
                                  mult=mult, unif=unif, key=[SEED, 7],
                                  tables=tk.clone())
        del tk, tp
        # kernel 6: the window flush on the flat (32*8, d, w) leaf view
        shape = (WINDOW_TENANTS, WINDOW_BUCKETS, 2, spec.storage_width)
        lk = zeros(shape, spec.storage_dtype, dev)
        lp = lk.clone()
        flat_k = lk.view((-1,) + shape[2:])
        flat_p = lp.view((-1,) + shape[2:])
        for f in flushes:
            if fname == "CMLS16" and f is last:
                keep["rows"] = dict(spec=spec, flat=flat_k.clone(), **f)
            ksk.fused_update_rows(flat_k, f["keys"], f["mult"], f["unif"],
                                  f["rows"], **kw)
            ref.fused_update_rows_plain(
                flat_p, f["skeys"], f["mult"], f["unif"],
                torch.from_numpy(f["rows"]).to(dev), seed_t, spec.counter,
                ksk.CHUNK, cpl=spec.cells_per_lane)
            torch.cuda.synchronize()
            same("fused_update_rows", f"{fname} leaf", lk, lp)
        del lp, flat_p
        # kernels 7, 8, 9 on the filled leaf, both modes
        qkw = dict(width=spec.width, counter=spec.counter,
                   cpl=spec.cells_per_lane)
        for mode in ("sum", "max"):
            for wname, wts in weight_sets:
                what = f"{fname} {mode} {wname}"
                got = ksk.window_query_stacked(lk, probes, wts, mode=mode,
                                               seeds=kw["seeds"], **qkw)
                want = ref.window_query_stacked_plain(lk, probes, wts, seed_t,
                                                      mode=mode, **qkw)
                same("window_query_stacked", what, got, want)
                rw = wts[refresh_rows].contiguous()
                got = ksk.window_query_stacked_rows(
                    lk, cand, rw, refresh_rows, mode=mode,
                    seeds=kw["seeds"], **qkw)
                want = ref.window_query_stacked_rows_plain(
                    lk, cand, rw, torch.from_numpy(refresh_rows).to(dev),
                    seed_t, mode=mode, **qkw)
                same("window_query_stacked_rows", what, got, want)
                got = ksk.window_query(lk[0], probes[0], wts[0], mode=mode,
                                       seeds=kw["seeds"], **qkw)
                want = ref.window_query_plain(lk[0], probes[0], wts[0],
                                              seed_t, mode=mode, **qkw)
                same("window_query", what, got, want)
        log(f"kernels 5-9 {fname}: fused_update tables, fused_update_rows "
            f"leaf (3 flushes), window_query / _stacked / _stacked_rows "
            "(sum and max, 3 weight sets) equal to their plain versions")
        check_rowmap_edges(dev, fname, spec, lk, last, weight_sets, cand,
                           same)
        check_lane_edges(dev, fname, spec, lk, probes, same)
        check_drawn_edges(dev, fname, spec, keys, same)
        if fname == "CMLS16":
            keep["window"] = dict(spec=spec, leaf=lk, probes=probes,
                                  cand=cand, rows=refresh_rows,
                                  weights=weight_sets[0][1])
        else:
            del lk
    return errs, keep


# ---- edge cases of the two row-mapped kernels (slice 4) ---------------------

UPDATE_EDGES = ("split", "one_row", "all_distinct", "one_key",
                "extreme_keys", "mult_zero", "high_states")
QUERY_EDGES = ("split", "one_row", "one_key", "all_distinct",
               "extreme_keys")
PLAIN_ROWS = 128  # rows a plain-version call lands (its int64 cells)


def distinct_keys(shape) -> np.ndarray:
    """Distinct uint32 keys over the whole range (an odd multiplier is a
    bijection mod 2^32)."""
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.uint64) * 2654435761 % 2**32).astype(
        np.uint32).reshape(shape)


def update_edge(case, dev, spec, flat, flush, rng, gen):
    """(tables, rows, raw keys, weights, uniforms) of one fused_update_rows
    edge case at the format's full width: on the window flush's filled
    flat leaf, but for "split" (MAX_MAPPED_ROWS + 37 rows of a fresh
    stack of random cells: two launches) and "high_states" (CMLS8: every
    cell in states 246-255, u = 0 and n in {450, 1489, 1923, 10000},
    where nfold steps one state past the reference property test's
    bound)."""
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import from_numpy, signed_view
    from repro_torch.kernels import sketch as ksk
    rows = flush["rows"]
    r, n = flush["keys"].shape
    tables = flat
    if case == "split":
        t = ksk.MAX_MAPPED_ROWS + 40
        tables = torch.empty((t,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                             device=dev)
        signed_view(tables).view(torch.uint8).random_(0, 256, generator=gen)
        rows = rng.permutation(t)[:t - 3]
        r, n = rows.size, 2048
    elif case == "one_row":
        rows, r = rows[:1], 1
    elif case == "high_states":
        states = torch.randint(246, 256, (r, 2, spec.width),
                               generator=gen, device=dev)
        tables = sk.storage_table(states, spec)
        rows = rng.permutation(r)
    raw = flush["keys"][:r]
    if case == "split":
        raw = from_numpy((rng.zipf(1.3, (r, n)) % 50_000).astype(np.uint32),
                         dev)
    elif case == "all_distinct":
        raw = from_numpy(distinct_keys((r, n)), dev)
    elif case == "one_key":
        raw = from_numpy(np.full((r, n), 4242, np.uint32), dev)
    elif case == "extreme_keys":
        raw = from_numpy(rng.choice(np.array([0, 0xFFFFFFFF], np.uint32),
                                    (r, n)), dev)
    weights = torch.ones((r, n), dtype=torch.float32, device=dev)
    unif = torch.rand((r, n), generator=gen, device=dev)
    if case == "mult_zero":
        weights.zero_()
    elif case == "high_states":
        weights = torch.from_numpy(rng.choice(
            np.array([450, 1489, 1923, 10000], np.float32), (r, n))).to(dev)
        unif.zero_()
    return tables, np.asarray(rows), raw, weights, unif


def query_edge(case, dev, cand, rng):
    """(rows, candidate keys) of one window_query_stacked_rows edge case on
    the filled 32-ring leaf: "split" reads MAX_MAPPED_ROWS + 37 rings
    (repeats allowed: a read) in two launches."""
    from repro_torch.core.counters import from_numpy, signed_view
    from repro_torch.kernels import sketch as ksk
    r, n = cand.shape
    rows = np.arange(r)[::-1].copy()
    keys = cand
    if case == "split":
        rows = rng.integers(0, r, ksk.MAX_MAPPED_ROWS + 37)
        keys = signed_view(cand)[torch.from_numpy(rows).to(dev), :PROBES]
        keys = keys.contiguous().view(torch.uint32)
    elif case == "one_row":
        rows, keys = rows[:1], cand[rows[0]][None].contiguous()
    elif case == "one_key":
        keys = from_numpy(np.full((r, n), 5, np.uint32), dev)
    elif case == "all_distinct":
        keys = from_numpy(distinct_keys((r, n)), dev)
    elif case == "extreme_keys":
        keys = from_numpy(rng.choice(np.array([0, 0xFFFFFFFF], np.uint32),
                                     (r, n)), dev)
    return rows, keys


def check_rowmap_edges(dev, fname, spec, leaf, flush, weight_sets, cand,
                       same) -> None:
    """Phase 5, edge cases: fused_update_rows and
    window_query_stacked_rows against their plain versions at full width
    in one storage format, exactly: UPDATE_EDGES (a call split over
    launches, R = 1, every key distinct, one key, keys 0 and 0xFFFFFFFF,
    mult == 0 everywhere, CMLS8 states >= 246 at u = 0) and QUERY_EDGES
    (a split call, R = 1, one key, 16,448 distinct keys a ring, keys 0
    and 0xFFFFFFFF) in both modes and three weight sets.  The plain update
    lands PLAIN_ROWS rows a call (rows are independent)."""
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import signed_view
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sketch as ksk
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    kw = dict(seeds=ops._seeds_tuple(spec), width=spec.width,
              counter=spec.counter, cpl=spec.cells_per_lane)
    seed_t = ops._seed_tensor(spec, dev)
    flat = leaf.view((-1,) + tuple(leaf.shape[2:]))
    done = []
    for case in UPDATE_EDGES:
        if case == "high_states" and spec.counter.bits != 8:
            continue
        base, rows, raw, weights, unif = update_edge(case, dev, spec, flat,
                                                     flush, rng, gen)
        skeys, mult = sk.dedup_weighted(raw, weights)
        got = base.clone()
        ksk.fused_update_rows(got, ops.as_device_keys(skeys, dev), mult,
                              unif, rows, **kw)
        want = base.clone() if case == "mult_zero" or base is flat else base
        for g in range(0, rows.size, PLAIN_ROWS):
            sl = slice(g, g + PLAIN_ROWS)
            ref.fused_update_rows_plain(
                want, skeys[sl], mult[sl], unif[sl],
                torch.from_numpy(rows[sl]).to(dev), seed_t, spec.counter,
                ksk.CHUNK, cpl=spec.cells_per_lane)
        torch.cuda.synchronize()
        same("fused_update_rows", f"{fname} {case}", got, want)
        if case == "mult_zero" and not torch.equal(signed_view(got),
                                                   signed_view(base)):
            fail(f"fused_update_rows {fname} mult_zero wrote cells")
        done.append(f"{case} ({rows.size} rows)")
        del base, got, want, skeys, mult, unif, raw
    qkw = dict(width=spec.width, counter=spec.counter,
               cpl=spec.cells_per_lane)
    for case in QUERY_EDGES:
        rows, keys = query_edge(case, dev, cand, rng)
        rows_t = torch.from_numpy(rows).to(dev)
        for mode in ("sum", "max"):
            for wname, wts in weight_sets:
                rw = wts[rows_t].contiguous()
                got = ksk.window_query_stacked_rows(
                    leaf, keys, rw, rows, mode=mode, seeds=kw["seeds"],
                    **qkw)
                want = ref.window_query_stacked_rows_plain(
                    leaf, keys, rw, rows_t, seed_t, mode=mode, **qkw)
                same("window_query_stacked_rows",
                     f"{fname} {case} {mode} {wname}", got, want)
    log(f"row-mapped edge cases {fname}: fused_update_rows {done}, "
        f"window_query_stacked_rows {list(QUERY_EDGES)} (sum and max, 3 "
        "weight sets) equal to their plain versions")


# ---- edge cases of the two lane kernels, 7 and 8 (slice 6) ------------------

LANE_EDGES = ("bucket0_zero", "all_zero", "n_buckets", "stride0",
              "one_key_n", "ragged", "passes", "extreme_keys", "repeated")
PASSES_RINGS = 4  # rings of the 300,000-key case


def lane_edge(case, dev, probes, rng):
    """(rings used, keys (R, N) or (N,) shared by every ring, [(label,
    (R, B) weights)]) of one edge case of kernels 7 and 8 on the filled
    32-ring leaf."""
    from repro_torch.core.counters import from_numpy
    from repro_torch.stream import window as w
    r, n = probes.shape
    cursors = np.arange(r) % WINDOW_BUCKETS
    full = w.window_weights_stacked(cursors, WINDOW_BUCKETS, device=dev)
    sets = [("full window", full)]
    keys = probes
    if case == "bucket0_zero":
        zero0 = full.clone()
        zero0[:, 0] = 0.0
        sets = [("bucket 0 zero", zero0)]
    elif case == "all_zero":
        sets = [("all zero", torch.zeros_like(full))]
    elif case == "n_buckets":
        sets = [(f"n_buckets={k}", w.window_weights_stacked(
            cursors, WINDOW_BUCKETS, n_buckets=k, device=dev))
            for k in range(1, WINDOW_BUCKETS + 1)]
    elif case == "stride0":
        keys = probes[3].contiguous()
    elif case == "one_key_n":
        keys = probes[:, :1].contiguous()
    elif case == "ragged":
        keys = from_numpy(rng.integers(0, 2**32, (r, 4096 + 33),
                                       dtype=np.uint64).astype(np.uint32),
                          dev)
    elif case == "passes":
        r = PASSES_RINGS
        keys = from_numpy(distinct_keys((r, 300_000)), dev)
        sets = [("gamma=0.9", w.window_weights_stacked(
            cursors[:r], WINDOW_BUCKETS, gamma=0.9, device=dev))]
    elif case == "extreme_keys":
        keys = from_numpy(rng.choice(np.array([0, 0xFFFFFFFF, 1,
                                               0xFFFFFFFE], np.uint32),
                                     (r, n)), dev)
    elif case == "repeated":
        keys = from_numpy(rng.integers(0, 5, (r, n)).astype(np.uint32), dev)
    return r, keys, sets


def check_lane_edges(dev, fname, spec, leaf, probes, same) -> None:
    """Phase 5, edge cases of kernels 7 and 8 at full width in one storage
    format, against their plain versions, exactly, in both modes:
    LANE_EDGES (a zero weight at bucket 0, every weight zero, the
    n_buckets masks 1..8, (N,) probes shared by every ring (ring stride
    0), N = 1, N not a multiple of the tile,
    300,000 keys a ring, keys 0 and 0xFFFFFFFF, repeated keys).  Kernel 8
    reads the 32-ring leaf (PASSES_RINGS rings for "passes"), kernel 7
    its ring 3."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sketch as ksk
    rng = np.random.default_rng(SEED + 9)
    seeds, seed_t = ops._seeds_tuple(spec), ops._seed_tensor(spec, dev)
    qkw = dict(width=spec.width, counter=spec.counter,
               cpl=spec.cells_per_lane)
    for case in LANE_EDGES:
        r, keys, sets = lane_edge(case, dev, probes, rng)
        rings = leaf[:r]
        plain_keys = keys if keys.dim() == 2 else keys.expand(r, -1)
        for mode in ("sum", "max"):
            for wname, wts in sets:
                what = f"{fname} {case} {mode} {wname}"
                got = ksk.window_query_stacked(rings, keys, wts, mode=mode,
                                               seeds=seeds, **qkw)
                want = ref.window_query_stacked_plain(
                    rings, plain_keys, wts, seed_t, mode=mode, **qkw)
                same("window_query_stacked", what, got, want)
                got = ksk.window_query(rings[3], plain_keys[3].contiguous(),
                                       wts[3].contiguous(), mode=mode,
                                       seeds=seeds, **qkw)
                same("window_query", what, got, want[3])
                if case == "all_zero" and bool(got.any()):
                    fail(f"window_query {what}: nonzero estimates")
        del keys, plain_keys
    log(f"lane-kernel edge cases {fname}: window_query and "
        f"window_query_stacked {list(LANE_EDGES)} (sum and max) equal to "
        "their plain versions")


# ---- edge cases of the two drawn updates (slice 5) --------------------------

DRAWN_EDGES = ("all_distinct", "one_key", "empty_lead", "short", "ragged",
               "one_row", "deep", "ragged_cand", "hi_word")
EDGE_ROWS = 8   # batch rows of an edge case
EDGE_TABLES = 11


def drawn_edge(case, dev, raw_epoch, rng):
    """(depth, rows, raw keys (R, N), weights, candidates (R, M), grid) of
    one edge case of fused_update_score / fused_update, on EDGE_ROWS rows
    of the tracked flush's traffic (65,536 Zipf keys a row): "all_distinct"
    65,536 distinct keys a row (64 chunks past the compaction plan),
    "one_key", "empty_lead" (the first 5 chunks of each sorted row dead: a
    hot key 0 of weight 0, the other keys >= 1), "short" N = 700 < CHUNK,
    "ragged" N = 3,405, "one_row", "deep" (depth 4), "ragged_cand" M = 77
    (the default M = 64 + N is itself not a multiple of the score tile),
    "hi_word" a decoupled (70,000, N) grid at rows >= 65,537, whose flat
    draw index needs the counter's high word."""
    from repro_torch.core.counters import from_numpy
    r, n, depth, grid = EDGE_ROWS, raw_epoch.shape[1], 2, None
    if case == "one_row":
        r = 1
    elif case == "short":
        n = 700
    elif case == "ragged":
        n = 3 * 1024 + 333
    elif case == "deep":
        depth = 4
    elif case == "hi_word":
        grid = (70_000, 65_537 + 7 * np.arange(r))
    raw = raw_epoch[:r, :n].contiguous()
    weights = torch.ones((r, n), dtype=torch.float32, device=dev)
    if case == "all_distinct":
        raw = from_numpy(distinct_keys((r, n)), dev)
    elif case == "one_key":
        raw = torch.full_like(raw, 4242)
    elif case == "empty_lead":
        lead = 5 * 1024 + 100
        raw = (i64(raw) % 0xFFFFFFFF + 1).to(torch.int32).view(torch.uint32)
        raw = raw.contiguous()
        raw.view(torch.int32)[:, :lead] = 0
        weights[:, :lead] = 0
    heap = from_numpy(rng.integers(0, 2**32, (r, TRACK_TOP),
                                   dtype=np.uint64).astype(np.uint32), dev)
    cand = torch.cat([heap.view(torch.int32), raw.view(torch.int32)],
                     dim=1).contiguous().view(torch.uint32)
    if case == "ragged_cand":
        cand = cand[:, :77].contiguous()
    return depth, rng.permutation(EDGE_TABLES)[:r], raw, weights, cand, grid


def check_drawn_edges(dev, fname, spec, raw_epoch, same) -> None:
    """Phase 5, edge cases of the two updates that draw their uniforms in
    the kernel, at full width in one storage format: fused_update_score
    (rows mapped into EDGE_TABLES tables of random cells) and fused_update
    (every table of its own stack) against their plain versions fed
    `prng.uniform_rows` of the same key and grid, exactly: states and
    estimates (so the draw, bit for bit), unlisted tables untouched."""
    from repro_torch.core import prng
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import signed_view
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sketch as ksk
    rng = np.random.default_rng(SEED + 8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    done = []
    for case in DRAWN_EDGES:
        depth, rows, raw, weights, cand, grid = drawn_edge(case, dev,
                                                           raw_epoch, rng)
        cspec = sk.SketchSpec(width=spec.width, depth=depth,
                              counter=spec.counter, packed=spec.packed,
                              seed=spec.seed)
        kw = dict(seeds=ops._seeds_tuple(cspec), width=cspec.width,
                  counter=cspec.counter, cpl=cspec.cells_per_lane)
        seed_t = ops._seed_tensor(cspec, dev)
        skeys, mult = sk.dedup_weighted(raw, weights)
        keys = ops.as_device_keys(skeys, dev)
        r, n = raw.shape
        key = [SEED, 300 + len(done)]
        base = torch.empty((EDGE_TABLES, depth, cspec.storage_width),
                           dtype=cspec.storage_dtype, device=dev)
        signed_view(base).view(torch.uint8).random_(0, 256, generator=gen)
        if cspec.counter.bits < 32:  # keep log states below the top
            signed_view(base).view(torch.uint8).bitwise_and_(0x3F)
        total, urows = (EDGE_TABLES, rows) if grid is None else grid
        unif = prng.uniform_rows(key, total, n, urows, device=dev)
        got = base.clone()
        _, est = ksk.fused_update_score(got, keys, mult, key, cand, rows,
                                        grid=grid, **kw)
        want = base.clone()
        _, west = ref.update_score_rows_ref(
            want, skeys, mult, unif, torch.from_numpy(rows).to(dev), cand,
            seed_t, cspec.counter, ksk.CHUNK, cpl=cspec.cells_per_lane)
        torch.cuda.synchronize()
        same("fused_update_score", f"{fname} {case} tables", got, want)
        same("fused_update_score", f"{fname} {case} estimates", est, west)
        free = np.setdiff1d(np.arange(EDGE_TABLES), rows)
        if not torch.equal(signed_view(got)[free], signed_view(base)[free]):
            fail(f"fused_update_score {fname} {case} wrote unlisted tables")
        total, urows = (r, np.arange(r)) if grid is None else grid
        unif = prng.uniform_rows(key, total, n, urows, device=dev)
        got = base[:r].clone()
        ksk.fused_update(got, keys, mult, key, grid=grid, **kw)
        want = ref.fused_update_plain(base[:r].clone(), skeys, mult, unif,
                                      seed_t, cspec.counter, ksk.CHUNK,
                                      cspec.cells_per_lane)
        torch.cuda.synchronize()
        same("fused_update", f"{fname} {case}", got, want)
        done.append(f"{case} ({r} x {n}, M {cand.shape[1]}, depth {depth})")
        del base, got, want, unif, skeys, mult, keys
    log(f"drawn-update edge cases {fname}: fused_update_score and "
        f"fused_update {done} equal to their plain versions")


def window_stream():
    """The windowed path's traffic: WINDOW_EPOCHS epochs of serve_counts'
    `metrics_qps` microbatches, each followed by a windowed microbatch of
    BATCH Zipf keys per windowed tenant at event time ts += exponential(25
    s).  Before epoch OUTAGE_EPOCH the event time jumps OUTAGE seconds (a
    producer outage longer than the ring), so the rings rotate by one
    interval, by several, and by more than B (a full clear)."""
    from repro_torch.launch import serve_counts as sc
    rng = np.random.default_rng(SEED + 2)
    epochs, ts = [], 0.0
    for e in range(WINDOW_EPOCHS):
        many, _ = sc.make_epoch(rng, 0, MICRO, BATCH)
        if e == OUTAGE_EPOCH:
            ts += OUTAGE
        pairs, ts = sc.make_trending(rng, WINDOW_TENANTS, MICRO, BATCH, ts)
        epochs.append((many, pairs))
    return epochs


def drive_window_epoch(svc, many, pairs) -> None:
    for events, (win_events, ts) in zip(many, pairs):
        svc.enqueue_many(events)
        svc.enqueue_many(win_events, ts=ts)
    svc.flush()


def run_window_path(spec, engine: str, dev, stream, probes):
    """The windowed service at full size (32 x 8 x 4 MiB leaf beside the
    CMS32 metrics plane) through the stream, with the dispatch audit of
    every windowed microbatch; then flush, query_all, query and topk."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_counts as sc
    from repro_torch.stream import tiering
    svc = sc.build_service(spec, 0, RING, SEED, TRACK_TOP, device=dev,
                           engine=engine, trending=WINDOW_TENANTS)
    plane = svc.planes[-1]
    steps_seen = {}
    for many, pairs in stream:
        for events, (win_events, ts) in zip(many, pairs):
            svc.enqueue_many(events)
            before = plane.epochs[0]
            pending = plane.pending()
            active = np.flatnonzero(plane.ring.fill)
            classes = len(tiering.fill_classes(plane.ring.fill, active,
                                               plane.ring.queue.shape[1]))
            with ops.audit_scope() as t:
                svc.enqueue_many(win_events, ts=ts)
            steps = 0 if before is None else plane.epochs[0] - before
            want = {"queue_append": 1}
            if steps:
                want["window_advance_rows"] = 1
                if pending:
                    want.update(update_rows=classes, window_query_stacked=1)
                steps_seen[steps] = steps_seen.get(steps, 0) + 1
            if dict(t) != want:
                fail(f"windowed microbatch at ts {ts:.1f} (rotation of "
                     f"{steps}, {pending} pending): dispatch audit "
                     f"{dict(t)} != {want}")
    tallies = {}
    with ops.audit_scope() as t:
        svc.flush()
    tallies["flush"] = dict(t)
    reads = {}
    for name, call in (
            ("query_all", lambda: svc.query_all(probes)),
            ("query", lambda: svc.query("trending_00", probes[2],
                                        n_buckets=3)),
            ("query_max", lambda: svc.query("trending_00", probes[2],
                                            mode="max")),
            ("query_gamma", lambda: svc.query("trending_00", probes[2],
                                              gamma=0.9)),
            ("topk", lambda: svc.topk("trending_00", n_buckets=3))):
        with ops.audit_scope() as t:
            reads[name] = call()
        tallies[name] = dict(t)
    torch.cuda.synchronize()
    return svc, reads, tallies, steps_seen


def run_untracked_path(spec, engine: str, dev, epochs, probes):
    """The 64 CMLS16 tenants without tracking: an epoch where every
    tenant is active in one fill class, then one where tenants 0-15 are
    active in two fill classes (8,192 and 24,576 keys)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_counts as sc
    svc = sc.build_service(spec, TENANTS, RING, SEED, None, device=dev,
                           engine=engine)
    tallies = {}
    for name, many in epochs:
        for events in many:
            svc.enqueue_many(events)
        with ops.audit_scope() as t:
            svc.flush()
        tallies[name] = dict(t)
    with ops.audit_scope() as t:
        counts = svc.query_all(probes)
    tallies["query_all"] = dict(t)
    torch.cuda.synchronize()
    return svc, counts, tallies


def untracked_epochs():
    """The untracked path's two epochs: every tenant with MICRO
    microbatches (one fill class); then tenants 0-15, the first half with
    one microbatch and the second with three (two fill classes)."""
    from repro_torch.launch import serve_counts as sc
    rng = np.random.default_rng(SEED + 4)
    active = min(16, TENANTS)
    uniform, _ = sc.make_epoch(rng, TENANTS, MICRO, BATCH)
    skewed, _ = sc.make_epoch(rng, active, 3, BATCH)
    heavy = {f"tenant_{t:02d}" for t in range(active // 2, active)}
    uniform = [{k: v for k, v in ev.items() if k.startswith("tenant_")}
               for ev in uniform]
    skewed = [{k: v for k, v in ev.items()
               if k.startswith("tenant_") and (i == 0 or k in heavy)}
              for i, ev in enumerate(skewed)]
    return [("uniform", uniform), ("skewed", skewed)]


def compare_services(a, b, what: str) -> None:
    from repro_torch.convert import service_to_numpy
    _, ta = service_to_numpy(a)
    _, tb = service_to_numpy(b)
    for kind in ("planes", "windows"):
        for i, (la, lb) in enumerate(zip(ta[kind], tb[kind])):
            for key, va in la.items():
                vb = lb[key]
                pairs = (va.items() if isinstance(va, dict)
                         else [(key, va)])
                for sub, x in pairs:
                    y = vb[sub] if isinstance(va, dict) else vb
                    if not np.array_equal(x, y):
                        fail(f"{what}: {kind}[{i}] {key} {sub}: auto and "
                             f"plain engines differ "
                             f"({int(np.sum(x != y))} entries)")


def slice2_paths(dev, spec, probes_win, probes_flat):
    """Phase 6: the windowed and the untracked services at full size with
    engine="auto", then "plain", on the card; launch counts per path."""
    from repro_torch.kernels import sketch as ksk
    stream = window_stream()
    ksk.reset_kernel_launches()
    wsvc, wreads, wtallies, steps_seen = run_window_path(
        spec, "auto", dev, stream, probes_win)
    win_launches = ksk.kernel_launches()
    log(f"windowed path kernel launches: {win_launches}")
    log(f"windowed path: rotations by steps {steps_seen}; dispatch tallies "
        f"{wtallies}")
    if not (1 in steps_seen and any(1 < k < WINDOW_BUCKETS
                                    for k in steps_seen)
            and any(k >= WINDOW_BUCKETS for k in steps_seen)):
        fail(f"the stream did not rotate by one, several and >= B "
             f"intervals: {steps_seen}")
    want = {"query_all": {"query_many": 1, "window_query_stacked": 1},
            "query": {"window_query": 1}, "query_max": {"window_query": 1},
            "query_gamma": {"window_query": 1},
            "topk": {"window_query_stacked": 1}}
    for k, v in want.items():
        if wtallies[k] != v:
            fail(f"windowed {k} dispatch audit {wtallies[k]} != {v}")
    if wtallies["flush"].get("window_query_stacked") != 1 or \
            "update_rows" not in wtallies["flush"]:
        fail(f"windowed flush audit {wtallies['flush']}")
    for name, est in wreads["query_all"].items():
        if est.shape != (PROBES,) or not bool(torch.isfinite(est).all()):
            fail(f"windowed query_all[{name}] not finite (N,)")
    hot, hot_est = wreads["topk"]
    if len(hot) == 0 or not (np.diff(hot_est) <= 0).all():
        fail("windowed topk empty or not descending")
    psvc, preads, ptallies, psteps = run_window_path(
        spec, "plain", dev, stream, probes_win)
    compare_services(wsvc, psvc, "windowed path")
    for k in ("query", "query_max", "query_gamma"):
        if not torch.equal(wreads[k], preads[k]):
            fail(f"windowed {k}: auto and plain differ")
    for n in wreads["query_all"]:
        if not torch.equal(wreads["query_all"][n], preads["query_all"][n]):
            fail(f"windowed query_all[{n}]: auto and plain differ")
    if not all(np.array_equal(x, y)
               for x, y in zip(wreads["topk"], preads["topk"])):
        fail("windowed topk: auto and plain differ")
    if ptallies != wtallies or psteps != steps_seen:
        fail("windowed path: plain-engine audit differs")
    log("windowed path: engine='plain' on the card gives equal leaves, "
        "cursors, watermarks, rings, fills, trackers and answers; top-3 "
        f"{[(int(k), float(v)) for k, v in zip(hot[:3], hot_est[:3])]}")
    del psvc

    epochs = untracked_epochs()
    ksk.reset_kernel_launches()
    usvc, ucounts, utallies = run_untracked_path(spec, "auto", dev, epochs,
                                                 probes_flat)
    flat_launches = ksk.kernel_launches()
    log(f"untracked path kernel launches: {flat_launches}")
    log(f"untracked path dispatch tallies: {utallies}")
    want = {"uniform": {"update_many": 1}, "skewed": {"update_rows": 2},
            "query_all": {"query_many": 2}}
    if utallies != want:
        fail(f"untracked dispatch audit {utallies} != {want}")
    psvc, pcounts, ptallies = run_untracked_path(spec, "plain", dev, epochs,
                                                 probes_flat)
    compare_services(usvc, psvc, "untracked path")
    for n in ucounts:
        if not torch.equal(ucounts[n], pcounts[n]):
            fail(f"untracked query_all[{n}]: auto and plain differ")
    log("untracked path: engine='plain' on the card gives equal tables and "
        "answers")
    for path, launches, names in (
            ("windowed", win_launches,
             ("fused_update_rows", "window_query", "window_query_stacked",
              "window_query_stacked_rows")),
            ("untracked", flat_launches,
             ("fused_update", "fused_update_rows"))):
        missing = [k for k in names if launches[k] == 0]
        if missing:
            fail(f"kernels not launched on the {path} path: {missing}")
    del psvc, usvc
    return wsvc, stream, win_launches, flat_launches


def window_times(dev, wsvc, keep, stream_rng, ts: float):
    """Phase 7: CUDA-event times of kernels 5-9 beside their plain
    versions and bytes bounds; the windowed ingest rate and query_all
    latency with kernels and with the plain engine.  Returns (kernel
    report, end-to-end numbers, the drive of one more windowed epoch for
    the profile of phase 9)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sketch as ksk
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_counts as sc
    report = {}
    u = keep["update"]
    spec = u["spec"]
    seeds = ops._seeds_tuple(spec)
    seed_t = ops._seed_tensor(spec, dev)
    kw = dict(seeds=seeds, width=spec.width, counter=spec.counter)
    work = u["tables"].clone()
    src = u["tables"]

    def reset():
        work.copy_(src)
    r, n = u["keys"].shape
    live = u["mult"] > 0
    n_live = int(live.sum())
    report["fused_update"] = dict(
        **timed(lambda: ksk.fused_update(work, u["keys"], u["mult"],
                                         u["key"], **kw), 10, setup=reset),
        plain_ms=cuda_ms(lambda: ref.fused_update_plain(
            work, u["skeys"], u["mult"], u["unif"], seed_t, spec.counter,
            ksk.CHUNK), 3, setup=reset),
        bytes=r * n * 8 + r * 8
        + 2 * sectors(spec, u["skeys"], mask=live) * SECTOR,
        ops=n_live * (spec.depth * 14 + 60 + DRAW_OPS),
        shape=f"tables {tuple(src.shape)} uint16, keys ({r}, {n}), "
              f"{n_live} distinct")

    f = keep["rows"]
    flat = f["flat"].clone()
    fsrc = f["flat"]
    rows_t = torch.from_numpy(f["rows"]).to(dev)

    def reset_flat():
        flat.copy_(fsrc)
    r, n = f["keys"].shape
    live = f["mult"] > 0
    n_live = int(live.sum())
    report["fused_update_rows"] = dict(
        **timed(lambda: ksk.fused_update_rows(
            flat, f["keys"], f["mult"], f["unif"], f["rows"], **kw), 20,
            setup=reset_flat),
        plain_ms=cuda_ms(lambda: ref.fused_update_rows_plain(
            flat, f["skeys"], f["mult"], f["unif"], rows_t, seed_t,
            spec.counter, ksk.CHUNK), 3, setup=reset_flat),
        bytes=r * n * 12 + r * 4
        + 2 * sectors(spec, f["skeys"], mask=live) * SECTOR,
        ops=n_live * (spec.depth * 14 + 60),
        shape=f"flat leaf {tuple(fsrc.shape)} uint16, rows {r}, keys "
              f"({r}, {n}), {n_live} distinct")

    g = keep["window"]
    leaf, probes, cand, rows = g["leaf"], g["probes"], g["cand"], g["rows"]
    wts = g["weights"]
    b = leaf.shape[1]
    qkw = dict(width=spec.width, counter=spec.counter)
    rw = wts[rows].contiguous()
    rows_d = torch.from_numpy(rows).to(dev)

    def qbytes(keys, n_rings):
        n_keys = keys.numel()
        return (n_keys * 8 + n_rings * b * 4
                + b * sectors(spec, i64(keys)) * SECTOR)

    def qops(keys):
        return keys.numel() * b * (spec.depth * 12 + 30)
    one_keys, one_w = probes[0].contiguous(), wts[0].contiguous()
    report["window_query"] = dict(
        **timed(lambda: ksk.window_query(leaf[0], one_keys, one_w,
                                         seeds=seeds, **qkw), 50),
        plain_ms=cuda_ms(lambda: ref.window_query_plain(
            leaf[0], one_keys, one_w, seed_t, **qkw), 10),
        bytes=qbytes(one_keys[None], 1), ops=qops(one_keys),
        shape=f"ring {tuple(leaf.shape[1:])} uint16, keys ({PROBES},)")
    report["window_query_stacked"] = dict(
        **timed(lambda: ksk.window_query_stacked(leaf, probes, wts,
                                                 seeds=seeds, **qkw), 50),
        plain_ms=cuda_ms(lambda: ref.window_query_stacked_plain(
            leaf, probes, wts, seed_t, **qkw), 10),
        bytes=qbytes(probes, probes.shape[0]), ops=qops(probes),
        shape=f"rings {tuple(leaf.shape)} uint16, keys "
              f"{tuple(probes.shape)}")
    report["window_query_stacked_rows"] = dict(
        **timed(lambda: ksk.window_query_stacked_rows(
            leaf, cand, rw, rows, seeds=seeds, **qkw), 20),
        plain_ms=cuda_ms(lambda: ref.window_query_stacked_rows_plain(
            leaf, cand, rw, rows_d, seed_t, **qkw), 5),
        bytes=qbytes(cand, cand.shape[0]) + len(rows) * 4, ops=qops(cand),
        shape=f"leaf {tuple(leaf.shape)} uint16, rows {len(rows)}, keys "
              f"{tuple(cand.shape)}")
    for rep in report.values():
        rep["library_ms"] = None
    # the card's random-read floor of kernels 7-9: each distinct word a
    # call reads, once, in random order (timed alone in phase 9)
    import time_read_kernels as trk
    for name, keys, at in (
            ("window_query", one_keys[None], [0]),
            ("window_query_stacked", probes, np.arange(leaf.shape[0])),
            ("window_query_stacked_rows", cand, rows)):
        words = trk.read_words(leaf, keys, at, spec)
        report[name]["floor"] = (trk.gather(leaf, words), int(words.numel()))

    # end to end on the windowed path
    probes_all = sc.probes_for(0, PROBES, WINDOW_TENANTS)

    def window_rate(svc, reps, ts):
        rates = []
        for _ in range(reps):
            many, _ = sc.make_epoch(stream_rng, 0, MICRO, BATCH)
            pairs, ts = sc.make_trending(stream_rng, WINDOW_TENANTS, MICRO,
                                         BATCH, ts)
            ev = sum(sum(v.size for v in m.values()) for m in many) + sum(
                sum(v.size for v in p[0].values()) for p in pairs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drive_window_epoch(svc, many, pairs)
            torch.cuda.synchronize()
            rates.append(ev / (time.perf_counter() - t0))
        return rates, ts

    def read_ms(read, reps):
        read()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            read()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def window_query_ms(svc, reps):
        return read_ms(lambda: svc.query_all(probes_all), reps)

    def window_one_ms(svc, reps):
        return read_ms(lambda: svc.query("trending_00", probes_all[2]), reps)
    spec_w = wsvc.planes[-1].spec
    rates, ts = window_rate(wsvc, 11, ts)
    e2e = {"window_ingest_events_per_s": summary(rates),
           "window_query_all_ms": summary(window_query_ms(wsvc, 200)),
           "window_query_ms": summary(window_one_ms(wsvc, 200))}
    psvc = sc.build_service(spec_w, 0, RING, SEED, TRACK_TOP, device=dev,
                            engine="plain", trending=WINDOW_TENANTS)
    e2e["window_ingest_events_per_s_plain"] = summary(
        window_rate(psvc, 3, 0.0)[0])
    e2e["window_query_all_ms_plain"] = summary(window_query_ms(psvc, 20))
    e2e["window_query_ms_plain"] = summary(window_one_ms(psvc, 20))
    del psvc
    log(f"windowed ingest events/s (8 x (enqueue_many metrics + "
        f"enqueue_many {WINDOW_TENANTS} windowed x {BATCH} at ts) + flush): "
        f"kernels {e2e['window_ingest_events_per_s']}, plain engine "
        f"{e2e['window_ingest_events_per_s_plain']}")
    log(f"windowed query_all ms ({len(probes_all)} x {PROBES} probes): "
        f"kernels {e2e['window_query_all_ms']}, plain engine "
        f"{e2e['window_query_all_ms_plain']}")
    log(f"windowed query ms (trending_00, {PROBES} probes): kernels "
        f"{e2e['window_query_ms']}, plain engine "
        f"{e2e['window_query_ms_plain']}")
    many, _ = sc.make_epoch(stream_rng, 0, MICRO, BATCH)
    pairs, _ = sc.make_trending(stream_rng, WINDOW_TENANTS, MICRO, BATCH, ts)
    return report, e2e, lambda: drive_window_epoch(wsvc, many, pairs)


# ---- the ring appends (slice 3) --------------------------------------------

APPEND_CASES = ("aligned_fill", "odd_fill", "zero_count", "full_row",
                "split")


def append_case(case: str, dense: bool, rng, dev):
    """(ring, keys, rows, fill, count) of one append at the main path's
    widths (a 65,536-key ring, 8,192-key batches): 64 rows, or for "split"
    MAX_APPEND_ROWS + 37 rows, so the call spans two launches; rows None
    for the dense kernel, else a permuted subset of the ring's rows."""
    from repro_torch.core.counters import from_numpy
    from repro_torch.kernels import ops
    from repro_torch.kernels import sketch as ksk
    t = ksk.MAX_APPEND_ROWS + 37 if case == "split" else TENANTS
    capw, n = ops.ring_width(RING), BATCH
    r = t if dense else t - 5
    ring = from_numpy(rng.integers(0, 2**32, (t, capw), dtype=np.uint64)
                      .astype(np.uint32), dev)
    keys = from_numpy(rng.integers(0, 2**32, (r, n), dtype=np.uint64)
                      .astype(np.uint32), dev)
    rows = None if dense else rng.permutation(t)[:r]
    count = rng.integers(1, n + 1, r)
    fill = rng.integers(0, capw - n + 1, r)
    if case in ("aligned_fill", "split"):  # 16-byte path, ragged tails
        fill -= fill % 4
    elif case == "odd_fill":  # 4-byte path
        fill |= 1
    elif case == "zero_count":
        count[::2] = 0
    elif case == "full_row":  # every row ends at capw
        fill = capw - count
    return ring, keys, rows, fill, count


def check_appends(dev, rng) -> None:
    """Phase 2, appends: both append kernels against their plain versions
    at full width and at the edge cases of APPEND_CASES: a call split
    over two launches, odd fill offsets, zero counts, rows that end at
    capw.  Ring cells exactly equal."""
    from repro_torch.core.counters import signed_view
    from repro_torch.kernels import ref
    from repro_torch.kernels import sketch as ksk

    def on_dev(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(dev)
    for case in APPEND_CASES:
        for dense in (True, False):
            ring, keys, rows, fill, count = append_case(case, dense, rng, dev)
            a, b = ring.clone(), ring
            if dense:
                ksk.queue_append_dense(a, keys, fill, count)
                ref.queue_append_dense_plain(b, keys, on_dev(fill),
                                             on_dev(count))
            else:
                ksk.queue_append(a, keys, rows, fill, count)
                ref.queue_append_plain(b, keys, on_dev(rows), on_dev(fill),
                                       on_dev(count))
            torch.cuda.synchronize()
            name = "queue_append_dense" if dense else "queue_append"
            if not torch.equal(signed_view(a), signed_view(b)):
                diff = int((signed_view(a) != signed_view(b)).sum())
                fail(f"{name} {case} ({tuple(ring.shape)} ring, "
                     f"{keys.shape[0]} rows): {diff} ring cells differ from "
                     "its plain version")
            del a, b, ring, keys
        log(f"queue_append_dense and queue_append, {case}: ring equal")


def check_enqueue_no_sync(dev, spec) -> dict:
    """Phase 8: 8 full-size `enqueue_many` microbatches on a fresh tracked
    service (64 x 8,192 keys each, beside metrics_qps) and a fresh windowed
    one (the metrics microbatch, then 32 x 8,192 windowed keys at event
    times inside ONE interval) under torch.cuda.set_sync_debug_mode
    ("error"): a synchronizing CUDA call in the append path fails the run.
    The batches fill the 65,536-key rings exactly, so nothing flushes and
    nothing rotates.  Then the same stream on the plain engine (outside
    the debug mode) must leave equal rings and fills.  Returns the
    kernel launches of the run with kernels."""
    from repro_torch.core.counters import signed_view
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    rng = np.random.default_rng(SEED + 5)
    many, _ = sc.make_epoch(rng, TENANTS, MICRO, BATCH)
    metrics, _ = sc.make_epoch(rng, 0, MICRO, BATCH)
    pairs, _ = sc.make_trending(rng, WINDOW_TENANTS, MICRO, BATCH, 0.0)
    start = 60.0 * 1000  # event times start..start+7 s: one 60 s interval

    def drive(engine: str):
        tracked = sc.build_service(spec, TENANTS, RING, SEED, TRACK_TOP,
                                   device=dev, engine=engine)
        windowed = sc.build_service(spec, 0, RING, SEED, TRACK_TOP,
                                    device=dev, engine=engine,
                                    trending=WINDOW_TENANTS)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(MICRO):
                tracked.enqueue_many(many[i])
                windowed.enqueue_many(metrics[i])
                windowed.enqueue_many(pairs[i][0], ts=start + i)
        except RuntimeError as err:
            fail(f"enqueue_many synchronized under set_sync_debug_mode"
                 f"('error'): {err}")
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
        return tracked, windowed

    ksk.reset_kernel_launches()
    auto = drive("auto")
    launches = ksk.kernel_launches()
    plain = drive("plain")
    want = {k: 0 for k in launches}
    want.update(queue_append=2 * MICRO, queue_append_dense=2 * MICRO)
    if launches != want:
        fail(f"sync-free enqueue_many kernel launches {launches} != {want}")
    for what, a, p in zip(("tracked", "windowed"), auto, plain):
        if a.stats["flushes"] or p.stats["flushes"]:
            fail(f"sync-free enqueue_many: the {what} service flushed")
        for i, (pa, pp) in enumerate(zip(a.planes, p.planes)):
            if not (np.array_equal(pa.ring.fill, pp.ring.fill)
                    and torch.equal(signed_view(pa.ring.queue),
                                    signed_view(pp.ring.queue))):
                fail(f"sync-free enqueue_many: {what} plane {i} ring or fill "
                     "differs from the plain engine's")
        full = [int(pa.ring.fill.min()) for pa in a.planes
                if pa.ring.fill.size > 2]
        if full != [RING]:
            fail(f"sync-free enqueue_many: {what} rings not full: {full}")
    log(f"sync-free enqueue_many: {MICRO} microbatches on the tracked and "
        "the windowed service under set_sync_debug_mode('error'), no "
        f"error; rings and fills equal the plain engine's; launches "
        f"{launches}")
    return launches


def check_flush_no_sync(dev, spec) -> dict:
    """Phase 8, flushes: on a fresh tracked service (64 tenants beside the
    metrics plane) and a fresh windowed one (32 tenants), under
    torch.cuda.set_sync_debug_mode("error"): a tracked flush of one full
    epoch; a window flush of one fill class (every windowed tenant one
    8,192-key microbatch); one of two fill classes (half the tenants one
    more microbatch, half three); then a windowed `enqueue_many(...,
    ts=)` two intervals on, which flushes the pending events, rotates and
    appends.  A synchronizing call fails the run.  The same stream on the
    plain engine (outside the debug mode) must leave equal tables, leaves,
    cursors, watermarks, rings, fills and trackers.  Returns the kernel
    launches of the run with kernels."""
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    rng = np.random.default_rng(SEED + 7)
    many, _ = sc.make_epoch(rng, TENANTS, MICRO, BATCH)
    pairs, _ = sc.make_trending(rng, WINDOW_TENANTS, 5, BATCH, 0.0)
    ev = [p[0] for p in pairs]
    names = sc.trending_names(WINDOW_TENANTS)
    light = set(names[:WINDOW_TENANTS // 2])
    start = 60.0 * 2000  # the start of an interval
    steps = [("one class", [(ev[0], start)]),
             ("two classes", [(ev[1], start + 1),
                              ({n: ev[2][n] for n in names
                                if n not in light}, start + 2),
                              ({n: ev[3][n] for n in names
                                if n not in light}, start + 3)]),
             ("flush and rotate", [({n: ev[4][n] for n in light},
                                    start + 4),
                                   (ev[0], start + 125)])]

    def drive(engine: str):
        tracked = sc.build_service(spec, TENANTS, RING, SEED, TRACK_TOP,
                                   device=dev, engine=engine)
        windowed = sc.build_service(spec, 0, RING, SEED, TRACK_TOP,
                                    device=dev, engine=engine,
                                    trending=WINDOW_TENANTS)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        what = "tracked flush"
        try:
            for events in many:
                tracked.enqueue_many(events)
            tracked.flush()
            for what, batches in steps:
                for events, ts in batches:
                    windowed.enqueue_many(events, ts=ts)
                if what != "flush and rotate":
                    windowed.flush()
        except RuntimeError as err:
            fail(f"{what} synchronized under set_sync_debug_mode('error'): "
                 f"{err}")
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
        return tracked, windowed

    ksk.reset_kernel_launches()
    auto = drive("auto")
    launches = ksk.kernel_launches()
    plain = drive("plain")
    for what, a, p in zip(("tracked", "windowed"), auto, plain):
        compare_services(a, p, f"sync-free flushes, {what} service")
    cursors = auto[1].planes[-1].cursors
    if set(cursors.tolist()) != {2}:
        fail(f"sync-free flushes: cursors {cursors.tolist()}, expected every "
             "ring rotated by two intervals")
    missing = [k for k in ("fused_update_score", "fused_update_rows",
                           "window_query_stacked_rows") if not launches[k]]
    if missing:
        fail(f"sync-free flushes launched none of {missing}")
    log("sync-free flushes: a tracked flush, window flushes of one and two "
        "fill classes and a windowed enqueue_many(ts=) that flushes and "
        "rotates, under set_sync_debug_mode('error'), no error; tables, "
        "leaves, cursors, rings, fills and trackers equal the plain "
        f"engine's; launches {launches}")
    del auto, plain
    return launches


def check_read_no_sync(dev, wsvc) -> dict:
    """Phase 8, reads: the windowed service of phases 6-7 (its planes
    clean) read under torch.cuda.set_sync_debug_mode("error"): `query` of
    a windowed tenant with the full window, n_buckets=2, gamma=0.9 and
    mode="max", and `query_all` with (N,) probes shared by every tenant
    and with per-tenant probes.  A synchronizing call fails the run.  A
    copy of the service on the plain engine must answer the same, exactly.
    Returns the kernel launches of the reads with kernels."""
    from repro_torch.convert import service_from_numpy, service_to_numpy
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    probes = sc.probes_for(0, PROBES, WINDOW_TENANTS)
    one = probes[7]  # trending_05's probes
    reads = [
        ("query", lambda s: s.query("trending_05", one)),
        ("query n_buckets=2",
         lambda s: s.query("trending_05", one, n_buckets=2)),
        ("query gamma=0.9", lambda s: s.query("trending_05", one,
                                              gamma=0.9)),
        ("query max", lambda s: s.query("trending_05", one, mode="max")),
        ("query_all shared", lambda s: s.query_all(one)),
        ("query_all per tenant", lambda s: s.query_all(probes))]
    if wsvc.dirty_planes:
        fail("sync-free reads: the windowed service has pending events")
    plain = service_from_numpy(*service_to_numpy(wsvc), device=dev,
                               engine="plain")
    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    got, what = {}, None
    try:
        for what, read in reads:
            got[what] = read(wsvc)
    except RuntimeError as err:
        fail(f"windowed {what} synchronized under set_sync_debug_mode"
             f"('error'): {err}")
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    launches = ksk.kernel_launches()
    for what, read in reads:
        a, b = got[what], read(plain)
        if isinstance(a, dict):
            bad = [n for n in a if not torch.equal(a[n], b[n])]
        else:
            bad = [] if torch.equal(a, b) else ["trending_05"]
        if bad:
            fail(f"sync-free reads: {what} differs from the plain engine's "
                 f"for {bad[:3]}")
    want = {k: 0 for k in launches}
    want.update(window_query=4, window_query_stacked=2, fused_query=2)
    if launches != want:
        fail(f"sync-free reads kernel launches {launches} != {want}")
    log("sync-free reads: windowed query (full window, n_buckets=2, "
        "gamma=0.9, max) and query_all (shared and per-tenant probes) "
        "under set_sync_debug_mode('error'), no error; answers equal the "
        f"plain engine's; launches {launches}")
    del plain
    return launches


def main(device: str = "cuda") -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root / "tools"))
    from repro_torch.convert import service_to_numpy
    from repro_torch.core import prng
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import (CMLS8, CMLS16, CMS32, from_numpy,
                                           signed_view, zeros)
    from repro_torch.core.hashing import row_hashes
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc

    torch.cuda.set_device(0)
    dev = torch.device(device)
    card = gpu_info()
    log(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.build(verbose=os.environ.get("CHIP_SMOKE_PTXAS") == "1")
    build.load()
    log(f"build: {time.perf_counter() - t0:.2f}s for "
        f"{[p.name for p in build.sources()]}")

    rng = np.random.default_rng(SEED)
    report: dict[str, dict] = {}

    def seeds_of(spec):
        return ops._seeds_tuple(spec)

    def seed_t(spec):
        return ops._seed_tensor(spec, dev)

    # ---- 2. kernels against their plain versions ---------------------------
    formats = [("CMS32", CMS32, False), ("CMLS16", CMLS16, False),
               ("CMLS16-packed", CMLS16, True), ("CMLS8", CMLS8, False),
               ("CMLS8-packed", CMLS8, True)]
    epoch_keys = []
    for _ in range(2):
        many, _ = sc.make_epoch(rng, TENANTS, MICRO, BATCH)
        keys = np.stack([np.concatenate([m[f"tenant_{t:02d}"] for m in many])
                         for t in range(TENANTS)])
        epoch_keys.append(from_numpy(keys, dev))
    rows_all = np.arange(TENANTS, dtype=np.int32)
    rows_d = torch.from_numpy(rows_all).to(dev)
    upd_err = 0.0
    qry_err = 0.0
    upd_inputs = {}
    for fname, counter, packed in formats:
        spec = sk.SketchSpec.from_memory(BUDGET, depth=2, counter=counter,
                                         packed=packed)
        tk = zeros((TENANTS, spec.depth, spec.storage_width),
                   spec.storage_dtype, dev)
        tp = zeros((TENANTS, spec.depth, spec.storage_width),
                   spec.storage_dtype, dev)
        tracker = torch.zeros((TENANTS, TRACK_TOP), dtype=torch.int32,
                              device=dev)
        for e, keys in enumerate(epoch_keys):
            weights = torch.ones(keys.shape, dtype=torch.float32, device=dev)
            skeys, mult = sk.dedup_weighted(keys, weights)
            unif = prng.uniform_rows([SEED, e], TENANTS, keys.shape[1],
                                     rows_all, device=dev)
            cand = torch.cat([tracker, signed_view(keys)], dim=1).view(
                torch.uint32)
            skeys_u = ops.as_device_keys(skeys, dev)
            _, est_k = ksk.fused_update_score(
                tk, skeys_u, mult, [SEED, e], cand, rows_all,
                seeds=seeds_of(spec), width=spec.width, counter=spec.counter,
                cpl=spec.cells_per_lane)
            _, est_p = ref.update_score_rows_ref(
                tp, skeys, mult, unif, rows_d, cand, seed_t(spec),
                spec.counter, ksk.CHUNK, cpl=spec.cells_per_lane)
            torch.cuda.synchronize()
            same_tab = torch.equal(signed_view(tk), signed_view(tp))
            same_est = torch.equal(est_k, est_p)
            err = float((est_k - est_p).abs().max())
            log(f"fused_update_score {fname} epoch {e}: tables equal "
                f"{same_tab}, estimates equal {same_est} (max abs {err})")
            if not (same_tab and same_est):
                diff = int((signed_view(tk) != signed_view(tp)).sum())
                fail(f"fused_update_score {fname} epoch {e} differs from "
                     f"its plain version: {diff} storage words, est max abs "
                     f"{err}")
            upd_err = max(upd_err, err)
            tracker = signed_view(keys[:, :TRACK_TOP]).contiguous()
            if fname == "CMLS16" and e == 1:
                upd_inputs = dict(spec=spec, tables=tk.clone(), keys=skeys_u,
                                  skeys=skeys, mult=mult, unif=unif,
                                  key=[SEED, e], cand=cand)
        probes = from_numpy(sc.probes_for(TENANTS, PROBES)[:TENANTS], dev)
        qk = ksk.fused_query(tk, probes, seeds=seeds_of(spec),
                             width=spec.width, counter=spec.counter,
                             cpl=spec.cells_per_lane)
        qp = ref.fused_query_plain(tk, probes, seed_t(spec), spec.width,
                                   spec.counter, spec.cells_per_lane)
        err = float((qk - qp).abs().max())
        log(f"fused_query {fname}: equal {torch.equal(qk, qp)} (max abs "
            f"{err})")
        if not torch.equal(qk, qp):
            fail(f"fused_query {fname} differs from its plain version: max "
                 f"abs {err}")
        qry_err = max(qry_err, err)
        if fname == "CMLS16":
            qry_inputs = dict(spec=spec, tables=tk.clone(), keys=probes)
        del tk, tp

    capw = ops.ring_width(RING)
    fill_d = (np.arange(TENANTS) % MICRO) * BATCH
    dense_keys = from_numpy(rng.integers(0, 2**32, (TENANTS, BATCH),
                                         dtype=np.uint64).astype(np.uint32),
                            dev)
    base_ring = from_numpy(rng.integers(0, 2**32, (TENANTS, capw),
                                        dtype=np.uint64).astype(np.uint32),
                           dev)
    count_d = np.full(TENANTS, BATCH)
    check_appends(dev, rng)

    # ---- 3. main path at full size -----------------------------------------
    spec = sk.SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16)
    log(f"main path: {TENANTS} tenants x {spec.memory_bytes} B "
        f"(width {spec.width}, depth {spec.depth}), ring {RING}, "
        f"track_top {TRACK_TOP}")
    stream_rng = np.random.default_rng(SEED + 1)
    many, single = sc.make_epoch(stream_rng, TENANTS, MICRO, BATCH)
    probes = sc.probes_for(TENANTS, PROBES)
    expected_events = TENANTS * MICRO * BATCH + MICRO * 256 + BATCH

    def run_stream(engine: str):
        svc = sc.build_service(spec, TENANTS, RING, SEED, TRACK_TOP,
                               device=dev, engine=engine)
        tallies = {}
        with ops.audit_scope() as t:
            for events in many:
                svc.enqueue_many(events)
        tallies["enqueue_many"] = dict(t)
        with ops.audit_scope() as t:
            svc.enqueue("tenant_00", single)
        tallies["enqueue"] = dict(t)
        with ops.audit_scope() as t:
            svc.flush()
        tallies["flush"] = dict(t)
        with ops.audit_scope() as t:
            counts = svc.query_all(probes)
        tallies["query_all"] = dict(t)
        with ops.audit_scope() as t:
            one = svc.query("tenant_00", probes[0])
        tallies["query"] = dict(t)
        with ops.audit_scope() as t:
            top = svc.topk("tenant_00")
        tallies["topk"] = dict(t)
        torch.cuda.synchronize()
        return svc, counts, one, top, tallies

    ksk.reset_kernel_launches()
    svc, counts, one, top, tallies = run_stream("auto")
    launches = ksk.kernel_launches()
    log(f"main path kernel launches: {launches}")
    log(f"main path dispatch tallies: {tallies}")
    missing = [k for k in ("fused_query", "fused_update_score",
                           "queue_append", "queue_append_dense")
               if launches[k] == 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    want = {
        "enqueue_many": {"queue_append": 2 * MICRO},
        "enqueue": {"queue_append": 1, "update_score_rows": 1},
        "flush": {"update_score_rows": 2},
        "query_all": {"query_many": 2},
        "query": {"query": 1},
        "topk": {},
    }
    if tallies != want:
        fail(f"dispatch audit {tallies} != expected {want}")
    if svc.stats["events"] != expected_events:
        fail(f"events {svc.stats} != {expected_events}")
    if [p.rng.draws for p in svc.planes] != [2, 1]:
        fail(f"flush epochs per plane {[p.rng.draws for p in svc.planes]}")
    for name, est in counts.items():
        if est.shape != (PROBES,) or not bool(torch.isfinite(est).all()):
            fail(f"query_all[{name}] not finite (N,)")
    if not torch.equal(one, counts["tenant_00"]):
        fail("query(tenant_00) != query_all[tenant_00]")
    hot, hot_est = top
    if len(hot) != TRACK_TOP:
        fail(f"topk returned {len(hot)} keys")
    q_hot = svc.query("tenant_00", hot).cpu().numpy()
    if not np.array_equal(q_hot, hot_est):
        fail("topk estimates != query answers for the same keys")
    if not (np.diff(hot_est) <= 0).all():
        fail("topk estimates not descending")
    log(f"main path: {svc.stats['events']} events, tenant_00 top-3 "
        f"{[(int(k), float(v)) for k, v in zip(hot[:3], hot_est[:3])]}")

    psvc, pcounts, pone, ptop, ptallies = run_stream("plain")
    _, tree_a = service_to_numpy(svc)
    _, tree_p = service_to_numpy(psvc)
    for i, (la, lp) in enumerate(zip(tree_a["planes"], tree_p["planes"])):
        for key in ("tables", "queue", "fill"):
            if not np.array_equal(la[key], lp[key]):
                fail(f"plane {i} {key}: auto and plain engines differ "
                     f"({int(np.sum(la[key] != lp[key]))} entries)")
        for key in ("keys", "estimates", "filled"):
            if not np.array_equal(la["topk"][key], lp["topk"][key]):
                fail(f"plane {i} tracker {key}: auto and plain differ")
    for name in counts:
        if not torch.equal(counts[name], pcounts[name]):
            fail(f"query_all[{name}]: auto and plain differ")
    if not (torch.equal(one, pone) and np.array_equal(top[0], ptop[0])
            and np.array_equal(top[1], ptop[1])):
        fail("query/topk: auto and plain differ")
    if ptallies != tallies:
        fail(f"plain-engine dispatch audit {ptallies} != {tallies}")
    log("main path: engine='plain' on the card gives equal tables, rings, "
        "fills, trackers and answers")
    main_launches = launches
    del psvc

    # ---- 4. times ------------------------------------------------------------
    # fused_query at query_all's shape (64 tenants x 1024 probes)
    spec_q = qry_inputs["spec"]
    tq, kq = qry_inputs["tables"], qry_inputs["keys"]
    t_q = timed(lambda: ksk.fused_query(
        tq, kq, seeds=seeds_of(spec_q), width=spec_q.width,
        counter=spec_q.counter), 50)
    pms = cuda_ms(lambda: ref.fused_query_plain(
        tq, kq, seed_t(spec_q), spec_q.width, spec_q.counter), 10)
    nkeys = kq.numel()
    qbytes = nkeys * 8 + sectors(spec_q, kq.view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF) * SECTOR
    qops = nkeys * (spec_q.depth * 12 + 30)
    report["fused_query"] = dict(
        **t_q, plain_ms=pms, library_ms=None, max_abs_err=qry_err,
        bytes=qbytes, ops=qops,
        shape=f"tables {tuple(tq.shape)} uint16, keys {tuple(kq.shape)}")

    # fused_update_score at the flush epoch's shape (64 rows x 65536 keys)
    u = upd_inputs
    spec_u = u["spec"]
    work = u["tables"].clone()
    src = u["tables"]

    def reset_work():
        work.copy_(src)

    t_u = timed(lambda: ksk.fused_update_score(
        work, u["keys"], u["mult"], u["key"], u["cand"], rows_all,
        seeds=seeds_of(spec_u), width=spec_u.width,
        counter=spec_u.counter), 10, setup=reset_work)
    pms = cuda_ms(lambda: ref.update_score_rows_ref(
        work, u["skeys"], u["mult"], u["unif"], rows_d, u["cand"],
        seed_t(spec_u), spec_u.counter, ksk.CHUNK), 3, setup=reset_work)
    r, n = u["keys"].shape
    m = u["cand"].shape[1]
    live = u["mult"] > 0
    skeys = u["skeys"]
    upd_sec = sectors(spec_u, skeys, mask=live)
    cand_i64 = u["cand"].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    cand_sec = sectors(spec_u, cand_i64)
    ubytes = (r * n * 8 + r * m * 8 + r * 8
              + (2 * upd_sec + cand_sec) * SECTOR)
    n_live = int(live.sum())
    uops = n_live * (spec_u.depth * 14 + 60 + DRAW_OPS) + r * m * (
        spec_u.depth * 12 + 30)
    report["fused_update_score"] = dict(
        **t_u, plain_ms=pms, library_ms=None, max_abs_err=upd_err,
        bytes=ubytes, ops=uops,
        shape=f"tables {(TENANTS, 2, spec_u.storage_width)} uint16, keys "
              f"({r}, {n}), {n_live} distinct, cand ({r}, {m})")

    # ring appends at enqueue_many's and enqueue's shapes, three ways: the
    # wrapper from host integers (CUDA events around one call), the kernel
    # alone on the device (torch.profiler), and one index_put_ with its
    # index tensors already on the card
    ring = base_ring.clone()
    fill_t = torch.from_numpy(fill_d).to(dev)
    count_t = torch.from_numpy(count_d).to(dev)
    t_a = timed(lambda: ksk.queue_append_dense(ring, dense_keys, fill_d,
                                               count_d), 50)
    pms = cuda_ms(lambda: ref.queue_append_dense_plain(
        ring, dense_keys, fill_t, count_t), 20)
    jj = torch.arange(BATCH, device=dev)
    dr = torch.arange(TENANTS, device=dev)[:, None].expand(-1, BATCH)
    dc = fill_t[:, None] + jj[None, :]
    dv = signed_view(dense_keys)
    dense_index_put = lambda: signed_view(ring).index_put_((dr, dc), dv)
    lms = cuda_ms(dense_index_put, 50)
    report["queue_append_dense"] = dict(
        **t_a, plain_ms=pms, library_ms=lms, max_abs_err=0.0,
        bytes=TENANTS * BATCH * 8 + 2 * TENANTS * 4, ops=0,
        shape=f"ring ({TENANTS}, {capw}), keys ({TENANTS}, {BATCH})")

    one_keys = dense_keys[:1].contiguous()
    one_rows, one_fill, one_count = (np.array([0]), np.array([0]),
                                     np.array([BATCH]))
    t_a = timed(lambda: ksk.queue_append(ring, one_keys, one_rows, one_fill,
                                         one_count), 50)
    pms = cuda_ms(lambda: ref.queue_append_plain(
        ring, one_keys, torch.zeros(1, dtype=torch.int64, device=dev),
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.full((1,), BATCH, dtype=torch.int64, device=dev)), 20)
    rr = torch.zeros((1, BATCH), dtype=torch.int64, device=dev)
    rc = jj[None, :]
    rv = signed_view(one_keys)
    rows_index_put = lambda: signed_view(ring).index_put_((rr, rc), rv)
    lms = cuda_ms(rows_index_put, 50)
    report["queue_append"] = dict(
        **t_a, plain_ms=pms, library_ms=lms, max_abs_err=0.0,
        bytes=BATCH * 8 + 3 * 4, ops=0,
        shape=f"ring ({TENANTS}, {capw}), keys (1, {BATCH})")
    append_calls = {
        "queue_append": (one_keys, one_rows, one_fill, one_count,
                         rows_index_put),
        "queue_append_dense": (dense_keys, None, fill_d, count_d,
                               dense_index_put)}
    append_host = append_host_us(dev, ring, append_calls)
    append_host["param_block"] = append_param_block_us(dev)
    log(f"append wrapper host time by part, us per call: {append_host}")

    # end to end: ingest rate (8 enqueue_many + flush) and query_all latency
    def ingest_rate(s, reps=3):
        rates = []
        for _ in range(reps):
            ep_many, _ = sc.make_epoch(stream_rng, TENANTS, MICRO, BATCH)
            ev = sum(sum(v.size for v in m.values()) for m in ep_many)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for events in ep_many:
                s.enqueue_many(events)
            s.flush()
            torch.cuda.synchronize()
            rates.append(ev / (time.perf_counter() - t0))
        return rates

    def query_all_ms(s, reps=10):
        s.query_all(probes)
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = s.query_all(probes)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        del res
        return out

    rates = summary(ingest_rate(svc, reps=11))
    qlat = summary(query_all_ms(svc, reps=200))
    psvc = sc.build_service(spec, TENANTS, RING, SEED, TRACK_TOP, device=dev,
                            engine="plain")
    prates = summary(ingest_rate(psvc, reps=3))
    pqlat = summary(query_all_ms(psvc, reps=20))
    del psvc
    log(f"ingest events/s (8 x enqueue_many + flush, {TENANTS} x {RING} "
        f"events per epoch): kernels {rates}, plain engine {prates}")
    log(f"query_all ms ({len(probes)} x {PROBES} probes): kernels {qlat}, "
        f"plain engine {pqlat}")
    prof_many = sc.make_epoch(stream_rng, TENANTS, MICRO, BATCH)[0]

    def drive_profiled():
        for events in prof_many:
            svc.enqueue_many(events)
        svc.flush()

    # ---- 5. kernels 5-9 against their plain versions -----------------------
    errs, keep = check_slice2_kernels(dev, formats, epoch_keys)
    del epoch_keys

    # ---- 6. the windowed and the untracked paths ---------------------------
    log(f"windowed path: {WINDOW_TENANTS} tenants x {WINDOW_BUCKETS} "
        f"buckets x {spec.memory_bytes} B leaf, ring {RING}, track_top "
        f"{TRACK_TOP}, beside the CMS32 metrics plane; {WINDOW_EPOCHS} "
        f"epochs; untracked path: {TENANTS} tenants, track_top None")
    wsvc, stream, win_launches, flat_launches = slice2_paths(
        dev, spec, sc.probes_for(0, PROBES, WINDOW_TENANTS),
        sc.probes_for(TENANTS, PROBES))

    # ---- 7. times of kernels 5-9 and of the windowed path -------------------
    report2, e2e2, drive_window = window_times(dev, wsvc, keep, stream_rng,
                                 stream[-1][1][-1][1])
    report["fused_update_score"]["max_abs_err"] = max(
        upd_err, errs.pop("fused_update_score"))
    for name, err in errs.items():
        report2[name]["max_abs_err"] = err
    report.update(report2)

    # ---- 8. enqueue_many and the flushes without a synchronizing call ------
    sync_launches = check_enqueue_no_sync(dev, spec)
    flush_launches = check_flush_no_sync(dev, spec)
    read_launches = check_read_no_sync(dev, wsvc)

    # ---- 9. profiles ---------------------------------------------------------
    # Last: a torch.profiler session leaves this process's later host work
    # slower (the append wrappers' host time below, before and after), so
    # every event and host-clock time above is taken before the first one.
    # The two epochs come first and in this order, as they did when the
    # script profiled them in phases 4 and 7: each is profiled after as
    # many earlier sessions as before, so the epochs stay comparable.
    profile = profile_epoch(drive_profiled)
    e2e2["profile_window_epoch"] = profile_epoch(drive_window)
    for name, kernel in KERNEL_NAMES.items():
        fn, setup, reps = report[name].pop("timed")
        report[name]["kernel_alone_ms"] = kernel_device_ms(
            fn, reps, kernel, setup)
        floor = report[name].pop("floor", None)
        report[name]["floor_ms"] = None
        if floor is not None:
            report[name]["floor_ms"] = kernel_device_ms(floor[0], 20,
                                                        ("index",))
            log(f"{name}: random-read floor {report[name]['floor_ms']:.5f} "
                f"ms for its {floor[1]} distinct words (one index kernel, "
                f"random order), kernel alone "
                f"{report[name]['kernel_alone_ms']:.5f} ms")
    for what, prof in (("tracked", profile),
                       ("windowed", e2e2["profile_window_epoch"])):
        log(f"one {what} epoch under torch.profiler: wall "
            f"{prof['wall_ms']:.3f} ms, device busy "
            f"{prof['device_busy_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.3f}, runtime calls "
            f"{prof['runtime_calls']}")
    append_host["after_profiler"] = append_host_us(dev, ring, append_calls)
    log("append wrapper host time by part after the profiler sessions, us "
        f"per call: {append_host['after_profiler']}")
    del svc, wsvc
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")

    src = "src/repro/kernels/sketch.py:"
    csrc = "src/repro_torch/kernels/csrc/"
    kernel_files = {
        "fused_query": (src + "298", csrc + "fused_query.cu"),
        "fused_update_score": (src + "422", csrc + "fused_update_score.cu"),
        "queue_append": (src + "526", csrc + "queue_append.cu"),
        "queue_append_dense": (src + "587", csrc + "queue_append.cu"),
        "fused_update": (src + "259", csrc + "fused_update_score.cu"),
        "fused_update_rows": (src + "344", csrc + "fused_update_rows.cu"),
        "window_query": (src + "618", csrc + "window_query.cu"),
        "window_query_stacked": (src + "686", csrc + "window_query.cu"),
        "window_query_stacked_rows": (src + "741", csrc + "window_query.cu"),
    }
    kernels = []
    for name, (replaces, source) in kernel_files.items():
        rep = report[name]
        t_bytes = rep["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = rep["ops"] / FP32_OPS_PER_S * 1e3
        launches = (main_launches[name] + win_launches[name]
                    + flat_launches[name] + sync_launches[name]
                    + flush_launches[name] + read_launches[name])
        if launches == 0:
            fail(f"{name} launched on none of the paths")
        log(f"{name} at {rep['shape']}: {rep['ms']:.4f} ms (kernel alone "
            f"{rep['kernel_alone_ms']:.5f} ms, wrapper host "
            f"{rep['host_us']:.1f} us), plain {rep['plain_ms']:.4f} ms, "
            f"library {rep['library_ms']}, bound {max(t_bytes, t_ops):.5f} "
            f"ms ({rep['bytes']} B, {rep['ops']} ops); launches tracked / "
            f"windowed / untracked path / sync-free enqueue / sync-free "
            f"flushes / sync-free reads {main_launches[name]} / "
            f"{win_launches[name]} / {flat_launches[name]} / "
            f"{sync_launches[name]} / {flush_launches[name]} / "
            f"{read_launches[name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "kernel_alone_ms": rep["kernel_alone_ms"],
            "host_us": rep["host_us"], "plain_ms": rep["plain_ms"],
            "random_read_floor_ms": rep["floor_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": rep["library_ms"]})
    print(json.dumps({"end_to_end": {
        "ingest_events_per_s": rates, "ingest_events_per_s_plain": prates,
        "query_all_ms": qlat, "query_all_ms_plain": pqlat,
        "append_host_us": append_host},
        "profile_epoch": profile, "window_path": e2e2}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
