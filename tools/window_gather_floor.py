"""What bounds the tracker refresh's window read: repeats, or the cells?

    python3 tools/window_gather_floor.py [--src path/to/src]

At the windowed path's full size (32 CMLS16 rings x 8 buckets x 4 MiB, a
1 GiB leaf of random cell states; 32 x 16,448 candidates: 64 heap keys
and two microbatches of serve_counts' Zipf traffic as they sit in the
ring), times on the card, kernel alone (torch.profiler), with L2 warm and
after 64 MiB of other writes:

  * rows_ring / rows_sorted -- `window_query_stacked_rows` on every
    candidate, in ring order (as the service passes them) and sorted;
  * dedup_cluster_* / dedup_tile_* -- the two designs of
    tools/window_dedup.cu that read each distinct (ring, key) once (one
    cluster of 8 blocks a ring sharing a hash table through distributed
    shared memory; one block a tile of 4,096 candidates with its own
    hash), in both orders, built here with the port's nvcc flags and held
    equal to `window_query_stacked_rows` first;
  * percand_all -- the `window_query_stacked` kernel (one lane a
    (candidate, bucket)) on every candidate (the rings are leaf rows
    0..31 in order);
  * percand_distinct -- the same kernel on each ring's distinct
    candidates only (every ring cut to the smallest distinct count);
  * gather_random / gather_sorted -- PyTorch's own index kernel reading
    the 32-bit word of every distinct (ring, key, bucket, row) cell once,
    one thread a word, in random order and in address order: the card's
    rate of random reads from the leaf, with every SM full of threads.

If gather_random takes about as long as percand_distinct, random reads of
the distinct cells from device memory set the time, whatever the kernel
around them.  Prints one JSON line with the card's name and power limit.
The dedup library is built under build/tools/ (git-ignored).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

TENANTS, BUCKETS, BATCH, TRACK_TOP, PROBES = 32, 8, 8192, 64, 1024


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_ms(fn, name: str, setup, reps: int = 20) -> float:
    """Mean device time of the kernels whose name holds `name`, over the
    launches torch.profiler recorded in `reps` calls of fn."""
    from torch.profiler import ProfilerActivity, profile
    setup()
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
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


def dedup_lib(build, root: pathlib.Path) -> ctypes.CDLL:
    """tools/window_dedup.cu built against the tree's csrc/, loaded."""
    src = root / "tools" / "window_dedup.cu"
    csrc = build.CSRC
    h = hashlib.sha256(" ".join(build.ARCH + build.FLAGS).encode())
    for p in [src, *sorted(csrc.glob("*.cu*"))]:
        h.update(p.read_bytes())
    lib = root / "build" / "tools" / h.hexdigest()[:16] / "libwq_dedup.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        cmd = [build.nvcc_path(), *build.ARCH, *build.FLAGS, "-shared",
               "-I", str(csrc), str(src), "-o", str(lib)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed: {res.stdout}{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    for name in ("cml_wq_dedup_cluster", "cml_wq_dedup_tile"):
        fn = getattr(dll, name)
        fn.argtypes = build.SIGNATURES["cml_window_query_stacked_rows"]
        fn.restype = ctypes.c_int
    return dll


def mix32(x: np.ndarray) -> np.ndarray:
    """csrc/common.cuh cml_mix32 on uint32 arrays."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "src"))
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

    dev = torch.device("cuda")
    spec = sk.SketchSpec.from_memory(4_194_304, depth=2, counter=CMLS16)
    seeds = ops._seeds_tuple(spec)
    kw = dict(seeds=seeds, width=spec.width, counter=spec.counter)
    leaf = torch.empty((TENANTS, BUCKETS, 2, spec.storage_width),
                       dtype=spec.storage_dtype, device=dev)
    signed_view(leaf).random_(0, 3000)
    rng = np.random.default_rng(3)
    pairs, _ = sc.make_trending(rng, TENANTS, 2, BATCH, 0.0)
    raw = np.stack([np.concatenate([ev[n] for ev, _ in pairs])
                    for n in sc.trending_names(TENANTS)])
    heap = sc.probes_for(0, PROBES, TENANTS)[2:, :TRACK_TOP]
    cand_np = np.concatenate([heap.astype(np.uint32),
                              raw.astype(np.uint32)], axis=1)
    ring_order = from_numpy(cand_np, dev)
    sorted_c = torch.sort(signed_view(ring_order), dim=1).values
    sorted_c = sorted_c.contiguous().view(torch.uint32)
    distinct_np = [np.unique(c) for c in cand_np]
    m = min(d.size for d in distinct_np)
    uniq = from_numpy(np.stack([d[:m] for d in distinct_np]), dev)
    # word index of every distinct (ring, key, bucket, row) cell
    wpr = spec.storage_width // 2  # CMLS16: two cells a 32-bit word
    idx = []
    for t, keys in enumerate(distinct_np):
        for k, seed in enumerate(seeds):
            col = mix32(keys ^ np.uint32(seed)) % np.uint32(spec.width)
            for b in range(BUCKETS):
                idx.append(((t * BUCKETS + b) * 2 + k) * wpr
                           + col.astype(np.int64) // 2)
    idx = np.concatenate(idx)
    words = leaf.view(torch.int32).view(-1)
    idx_random = torch.from_numpy(rng.permutation(idx)).to(dev)
    idx_sorted = torch.from_numpy(np.sort(idx)).to(dev)
    rows = np.arange(TENANTS)
    wts = w.window_weights_stacked(np.full(TENANTS, 5), BUCKETS, device=dev)
    lib = dedup_lib(build, pathlib.Path(__file__).resolve().parents[1])
    rows_d = torch.arange(TENANTS, dtype=torch.int32, device=dev)
    wpr_leaf = leaf.shape[-1] * leaf.element_size() // 4
    counter_args = ksk._counter_args(spec.counter)
    seed_arr = ksk._seed_array(seeds)

    def dedup(design, cand):
        out = torch.empty(cand.shape, dtype=torch.float32, device=dev)
        rc = getattr(lib, "cml_wq_dedup_" + design)(
            leaf.data_ptr(), TENANTS, BUCKETS, 2, wpr_leaf,
            rows_d.data_ptr(), cand.data_ptr(), cand.shape[1],
            wts.data_ptr(), out.data_ptr(), 0, seed_arr, spec.width,
            *counter_args, ksk._stream(dev))
        if rc:
            raise RuntimeError(f"dedup {design}: CUDA error {rc}")
        return out

    for design in ("cluster", "tile"):
        for cand in (ring_order, sorted_c):
            want = ksk.window_query_stacked_rows(leaf, cand, wts, rows, **kw)
            if not torch.equal(dedup(design, cand), want):
                raise RuntimeError(f"dedup {design} differs from the kernel")
    other = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    settings = {"warm": lambda: None, "after_64MiB": lambda: other.zero_()}
    calls = {
        "rows_ring": (lambda: ksk.window_query_stacked_rows(
            leaf, ring_order, wts, rows, **kw), "window_query_rows_kernel"),
        "rows_sorted": (lambda: ksk.window_query_stacked_rows(
            leaf, sorted_c, wts, rows, **kw), "window_query_rows_kernel"),
        "dedup_cluster_ring": (lambda: dedup("cluster", ring_order),
                               "dedup_cluster_kernel"),
        "dedup_cluster_sorted": (lambda: dedup("cluster", sorted_c),
                                 "dedup_cluster_kernel"),
        "dedup_tile_ring": (lambda: dedup("tile", ring_order),
                            "dedup_tile_kernel"),
        "dedup_tile_sorted": (lambda: dedup("tile", sorted_c),
                              "dedup_tile_kernel"),
        "percand_all": (lambda: ksk.window_query_stacked(
            leaf, ring_order, wts, **kw), "window_query_kernel"),
        "percand_distinct": (lambda: ksk.window_query_stacked(
            leaf, uniq, wts, **kw), "window_query_kernel"),
        "gather_random": (lambda: words[idx_random], "index"),
        "gather_sorted": (lambda: words[idx_sorted], "index"),
    }
    out = {"card": card(), "candidates": list(ring_order.shape),
           "distinct_per_ring": [int(d.size) for d in distinct_np],
           "distinct_kept": m, "gathered_words": int(idx.size),
           "gathered_sectors": int(np.unique(idx // 8).size)}
    for name, (fn, kernel) in calls.items():
        out[name] = {s: kernel_ms(fn, kernel, setup)
                     for s, setup in settings.items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
