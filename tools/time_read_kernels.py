"""Time the windowed reads, their kernels and the card's random-read floor.

    python3 tools/time_read_kernels.py --src path/to/src --label change-1

Builds the CUDA kernels of the tree under `--src` (its
`repro_torch/kernels/csrc`) and measures, at `chip_smoke.py`'s full sizes
(CMLS16, width 1,048,576, depth 2; tables of random cell states):

  * kernel alone (torch.profiler's device duration, mean over the calls)
    and CUDA-event ms a call of kernel 1 (`fused_query`, 64 tables x
    1,024 probes), kernel 7 (`window_query`, one (8, 2, 1,048,576) ring x
    1,024 probes, full-window weights and n_buckets=2), kernel 8
    (`window_query_stacked`, a (32, 8, 2, 1,048,576) leaf x (32, 1,024)
    per-ring probes, and (1,024,) probes shared by every ring where the
    tree takes them) and kernel 9 (`window_query_stacked_rows`, the
    leaf's 32 rings x 16,448 tracker-refresh candidates);
  * the random-read floor of kernels 7, 8 and 9: PyTorch's index kernel
    reading once, in random order, each distinct 32-bit word the
    kernel's call reads (`read_words`), one thread a word;
  * each kernel and floor twice: "warm" (the same call again, its words
    left in L2 by the last one) and "cold" (64 MiB written before each
    call, untimed, so the words come from device memory);
  * the same floor against the span of the addresses: 524,288 random
    words within the leaf's first 32 MiB, 256 MiB and 1 GiB;
  * a windowed service (`serve_counts.build_service`: the CMS32 metrics
    plane and 32 windowed CMLS16 tenants of 8 x 60 s buckets, filled by
    three epochs of its traffic): `query` of one tenant (1,024 probes) and
    `query_all` (per-tenant (34, 1,024) probes, and shared (1,024,)
    ones): latency p50 / p95 over 200 calls (host clock around a call
    that ends in `torch.cuda.synchronize()`), host us of the call alone,
    its host time by function (cProfile over 100 calls, the top 12 by
    own time), and, under torch.profiler over 20 calls, device ms and the
    `cudaLaunchKernel`, `cudaMemcpyAsync`, `cudaStreamSynchronize` and
    `cudaEventSynchronize` calls a read.

Only public signatures that the parent and the change share are timed
(shared probes are tried, and reported null where a tree refuses them),
so the same script times both trees in one call: run it against each
tree's `src/` in turn, parent, change, change, parent.  Prints one JSON
line with the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import time_flush_kernels as tf  # noqa: E402  (card, timing helpers)

SEED = 0
TENANTS = 64
WINDOW_TENANTS = 32
BUCKETS = 8
BATCH = 8192
MICRO = 8
RING = 65_536
TRACK_TOP = 64
PROBES = 1024
BUDGET = 4_194_304
READS = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize",
         "cudaEventSynchronize")


def read_words(leaf: torch.Tensor, keys: torch.Tensor, rows, spec
               ) -> torch.Tensor:
    """Flat int32-word indices into `leaf` (T, B, d, sw) of the distinct
    words a window read of rings `rows` (R,) at keys (R, N) reads: every
    bucket's d cells of every key, each word once."""
    from repro_torch.core.hashing import row_hashes
    from repro_torch.kernels import ops
    dev = leaf.device
    _, b, d, sw = leaf.shape
    wpr = sw * leaf.element_size() // 4
    k64 = keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    cols = row_hashes(k64, ops._seed_tensor(spec, dev), spec.width)
    word = (cols // (32 // spec.counter.bits))[..., None]  # (d, R, N, 1)
    ring = torch.as_tensor(np.asarray(rows), device=dev).view(1, -1, 1, 1)
    bucket = torch.arange(b, device=dev).view(1, 1, 1, b)
    row = torch.arange(d, device=dev).view(d, 1, 1, 1)
    return torch.unique(((ring * b + bucket) * d + row) * wpr + word)


def gather(leaf: torch.Tensor, words: torch.Tensor, seed: int = 0):
    """The floor's call: `words` in a random order, read with one index
    kernel (its profiler name holds "index")."""
    flat = leaf.view(torch.int32).view(-1)
    gen = torch.Generator().manual_seed(seed)
    order = words[torch.randperm(words.numel(), generator=gen).to(
        words.device)]
    return lambda: flat[order]


def kernel_ms(fn, names, reps: int, setup=None) -> float:
    """Kernel alone: mean device ms of the kernels named by `names` a
    call, over `reps` calls under torch.profiler."""
    return tf.kernel_alone_ms(tf.device_rows(fn, reps, setup), names, reps)


def warm_cold(fn, names, reps: int, evict) -> dict:
    return {"warm": kernel_ms(fn, names, reps),
            "cold": kernel_ms(fn, names, reps, setup=evict)}


def host_steps(fn, reps: int = 100, top: int = 12) -> list:
    """Where one call's host time goes: cProfile over `reps` calls, the
    `top` functions by own time, as [name, us a call, calls a call]
    (cProfile's own cost inflates each call's time)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = []
    for (path, line, name), (_, ncalls, tottime, _, _) in \
            pstats.Stats(prof).stats.items():
        rows.append([f"{pathlib.Path(path).name}:{line}({name})",
                     tottime / reps * 1e6, ncalls / reps])
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def read_stats(fn, reps: int = 200, prof_reps: int = 20) -> dict:
    """One read's latency p50 / p95 (ms), host us, the host time by
    function (`host_steps`), and device ms and runtime calls a read under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    lat, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e6)
        lat.append((t2 - t0) * 1e3)
    torch.cuda.synchronize()
    steps = host_steps(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_reps):
            fn()
        torch.cuda.synchronize()
    calls = dict.fromkeys(READS, 0)
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            if ev.key in calls:
                calls[ev.key] += ev.count
        else:
            busy += ev.self_device_time_total / 1e3
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "host_us": float(np.mean(host)),
            "device_ms": busy / prof_reps,
            "calls_per_read": {k: v / prof_reps for k, v in calls.items()},
            "host_steps": steps}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="a tree's src/ directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import CMLS16, from_numpy, signed_view
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    from repro_torch.stream import window as w

    build.load()
    dev = torch.device("cuda")
    spec = sk.SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16)
    kw = dict(seeds=ops._seeds_tuple(spec), width=spec.width,
              counter=spec.counter, cpl=spec.cells_per_lane)
    out = {"label": args.label, "src": args.src, "card": tf.card()}
    other = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def evict():
        other.zero_()

    # kernel 1 at query_all's shape on the tracked plane
    tables = torch.empty((TENANTS, 2, spec.storage_width),
                         dtype=spec.storage_dtype, device=dev)
    signed_view(tables).random_(0, 3000)
    qkeys = from_numpy(sc.probes_for(TENANTS, PROBES)[:TENANTS], dev)
    query = lambda: ksk.fused_query(tables, qkeys, **kw)  # noqa: E731
    out["fused_query"] = dict(ms=tf.event_ms(query, args.reps),
                              alone=warm_cold(query, ("fused_query_kernel",),
                                              args.reps, evict))
    del tables

    # kernels 7, 8, 9 on a 1 GiB window leaf
    leaf = torch.empty((WINDOW_TENANTS, BUCKETS, 2, spec.storage_width),
                       dtype=spec.storage_dtype, device=dev)
    signed_view(leaf).random_(0, 3000)
    probes = from_numpy(sc.probes_for(0, PROBES, WINDOW_TENANTS)[2:], dev)
    cursors = np.full(WINDOW_TENANTS, 5)
    full = w.window_weights_stacked(cursors, BUCKETS, device=dev)
    two = w.window_weights_stacked(cursors, BUCKETS, n_buckets=2, device=dev)
    rng = np.random.default_rng(3)  # tools/window_gather_floor.py's draw
    pairs, _ = sc.make_trending(rng, WINDOW_TENANTS, 2, BATCH, 0.0)
    raw = np.stack([np.concatenate([ev[n] for ev, _ in pairs])
                    for n in sc.trending_names(WINDOW_TENANTS)])
    cand = torch.cat([signed_view(probes[:, :TRACK_TOP]),
                      signed_view(from_numpy(raw, dev))], dim=1).view(
                          torch.uint32)
    rows = np.arange(WINDOW_TENANTS)[::-1].copy()
    one_keys = probes[0].contiguous()
    lanes = ("window_query_kernel",)
    calls = {
        "window_query": (lambda: ksk.window_query(
            leaf[0], one_keys, full[0].contiguous(), **kw), lanes),
        "window_query_n_buckets_2": (lambda: ksk.window_query(
            leaf[0], one_keys, two[0].contiguous(), **kw), lanes),
        "window_query_stacked": (lambda: ksk.window_query_stacked(
            leaf, probes, full, **kw), lanes),
        "window_query_stacked_shared": (lambda: ksk.window_query_stacked(
            leaf, one_keys, full, **kw), lanes),
        "window_query_stacked_rows": (lambda: ksk.window_query_stacked_rows(
            leaf, cand, full[rows].contiguous(), rows, **kw),
            ("window_query_rows_kernel",)),
    }
    for name, (fn, names) in calls.items():
        try:
            fn()
        except ValueError as err:  # a tree without shared probes
            out[name] = {"refused": str(err)}
            continue
        out[name] = dict(ms=tf.event_ms(fn, args.reps),
                         host_us=tf.host_us(fn, args.reps),
                         alone=warm_cold(fn, names, args.reps, evict))
    floors = {"window_query": read_words(leaf, probes[:1], [0], spec),
              "window_query_stacked": read_words(
                  leaf, probes, np.arange(WINDOW_TENANTS), spec),
              "window_query_stacked_rows": read_words(leaf, cand, rows,
                                                      spec)}
    out["floor"] = {}
    for name, words in floors.items():
        out["floor"][name] = dict(
            words=int(words.numel()),
            sectors=int(torch.unique(words // 8).numel()),
            alone=warm_cold(gather(leaf, words), ("index",), args.reps,
                            evict))
    # the floor against the span of the addresses: 524,288 random words
    # (kernel 8's count) within the leaf's first 32 MiB (one ring),
    # 256 MiB and all of its 1 GiB
    out["floor_by_span"] = {}
    flat_words = leaf.numel() * leaf.element_size() // 4
    gen = torch.Generator().manual_seed(SEED)
    for mib in (32, 256, 1024):
        span = min(flat_words, mib * 2**18)
        words = torch.randint(0, span, (524_288,), generator=gen).to(dev)
        out["floor_by_span"][f"{mib}MiB"] = warm_cold(
            gather(leaf, words), ("index",), args.reps, evict)
    del leaf, floors, other

    # the windowed service's reads
    svc = sc.build_service(spec, 0, RING, SEED, TRACK_TOP, device=dev,
                           trending=WINDOW_TENANTS)
    srng = np.random.default_rng(SEED + 2)
    ts = 0.0
    for _ in range(3):
        many, _ = sc.make_epoch(srng, 0, MICRO, BATCH)
        pairs, ts = sc.make_trending(srng, WINDOW_TENANTS, MICRO, BATCH, ts)
        for events, (wev, t) in zip(many, pairs):
            svc.enqueue_many(events)
            svc.enqueue_many(wev, ts=t)
        svc.flush()
    torch.cuda.synchronize()
    every = sc.probes_for(0, PROBES, WINDOW_TENANTS)
    out["service"] = {
        "query": read_stats(lambda: svc.query("trending_00", every[2])),
        "query_all": read_stats(lambda: svc.query_all(every)),
        "query_all_shared": read_stats(lambda: svc.query_all(every[2]))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
