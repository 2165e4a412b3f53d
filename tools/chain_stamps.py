"""Where kernel 5's chain spends its cycles: section stamps of its chain.

    python3 tools/chain_stamps.py --src src [--eager-draw]

Copies the tree's `repro_torch` under `build/tools/chain_stamps/`, adds
`clock64()` stamps to `kernels/csrc/update_chain.cuh` (each block's
thread 0 adds the cycles of each section to a `__device__` array, read
back through an added C entry point), builds the copy and runs kernel 5
(`fused_update`, the untracked all-active flush) once at the tracked
flush's full shape: 64 CMLS16 tenants x 4 MiB, 65,536 Zipf events a
tenant (serve_counts' traffic, as `chip_smoke.py`'s kernel phase draws
it).  Sections, in cycles a block:

  * mult_scan, compact_loop, draw -- the compaction (the mult pass and
    the scan; the compacting loop; the deferred draw, with a barrier the
    stamps add);
  * issue, nfold, merge, barrier1, store_free, barrier2 -- the chain,
    summed over the chunks with a live slot (`chunks`): the reads'
    issue, the wait for them and nfold, the shared-memory merge, the
    barrier, the stores, the barrier.

--eager-draw runs the copy with the uniforms drawn inside the compacting
loop, as each live slot is found.  Also prints kernel 5's time by CUDA
events (the stamps' own cost included) and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("mult_scan", "compact_loop", "draw", "issue", "nfold", "merge",
         "barrier1", "store_free", "barrier2", "chunks", "chain_total")
STAMP = ("#define STAMP(i) if (threadIdx.x == 0) { unsigned long long "
         "now_ = clock64(); atomicAdd(&cml_stamps[i], now_ - t_last); "
         "t_last = now_; }\n")
CLOCK = "unsigned long long t_last = clock64(), t_first = t_last;\n"


def patch(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"anchor not found: {old[:60]!r}")
        text = text.replace(old, new, 1)
    return text


def stamped_copy(src: pathlib.Path, dst: pathlib.Path, eager: bool) -> None:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = dst / "repro_torch" / "kernels" / "csrc"
    chain = csrc / "update_chain.cuh"
    chain.write_text(patch(chain.read_text(), [
        ("namespace {\n\nconstexpr int CHUNK = 1024;",
         "namespace {\n__device__ unsigned long long cml_stamps[16];\n"
         + STAMP + "\nconstexpr int CHUNK = 1024;"),
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
         "  // live counts", "  " + CLOCK
         + "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
         "  // live counts"),
        ("  if (total > (uint32_t)LIVE) return false;",
         "  if (total > (uint32_t)LIVE) return false;\n  STAMP(0)"),
        ("  if (tid == 0) starts[nch] = total;\n  __syncthreads();",
         "  if (tid == 0) starts[nch] = total;\n  __syncthreads();\n"
         "  STAMP(1)"),
        ("(int)__float_as_uint(cu[e]), n);\n    }\n  }",
         "(int)__float_as_uint(cu[e]), n);\n    }\n    __syncthreads();\n"
         "    STAMP(2)\n  }"),
        # the chunk loop
        ("  for (int c = 0; c < nch; ++c) {\n    // this thread's slot",
         "  " + CLOCK + "  for (int c = 0; c < nch; ++c) {\n"
         "    // this thread's slot"),
        ("      if (lo == hi) continue;  // no live slot: the same for every "
         "thread\n",
         "      if (lo == hi) continue;  // no live slot: the same for every "
         "thread\n      if (tid == 0) atomicAdd(&cml_stamps[9], 1ull);\n"),
        ("    const uint32_t nv =\n        slot_state<BITS, D>(depth, mu, u, "
         "col, word, ctr, dtab, etab, ts);\n    // merge: no device-memory "
         "write yet, so no barrier before it\n    merge_state<BITS, D>(table, "
         "SLOTS, depth, wpr, nv, col, word, own);\n    __syncthreads();",
         "    STAMP(3)\n    const uint32_t nv =\n        slot_state<BITS, D>("
         "depth, mu, u, col, word, ctr, dtab, etab, ts);\n    STAMP(4)\n"
         "    merge_state<BITS, D>(table, SLOTS, depth, wpr, nv, col, word, "
         "own);\n    STAMP(5)\n    __syncthreads();\n    STAMP(6)"),
        ("        table[own[k] - 1u] = FREE;\n      }\n    }\n    "
         "__syncthreads();\n  }\n}",
         "        table[own[k] - 1u] = FREE;\n      }\n    }\n    STAMP(7)\n"
         "    __syncthreads();\n    STAMP(8)\n  }\n  if (tid == 0) "
         "atomicAdd(&cml_stamps[10], clock64() - t_first);\n}"),
    ] + ([("  static constexpr bool kDeferred = true;",
           "  static constexpr bool kDeferred = false;")] if eager else [])))
    score = csrc / "fused_update_score.cu"
    score.write_text(score.read_text() + """
extern "C" int cml_stamps_read(void* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, cml_stamps, sizeof(cml_stamps));
  if (e != cudaSuccess || !reset) return (int)e;
  static const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(cml_stamps, zero, sizeof(zero));
}
""")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="src", help="a tree's src/ directory")
    ap.add_argument("--eager-draw", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    label = "eager_draw" if args.eager_draw else "deferred_draw"
    copy = ROOT / "build" / "tools" / "chain_stamps" / label
    stamped_copy(pathlib.Path(args.src).resolve(), copy, args.eager_draw)
    sys.path.insert(0, str(copy))
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import CMLS16, from_numpy, zeros
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    build.BUILD_ROOT = copy / "build"
    lib = build.load()
    lib.cml_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    spec = sk.SketchSpec.from_memory(4_194_304, depth=2, counter=CMLS16)
    rng = np.random.default_rng(0)  # chip_smoke's kernel phase
    epochs = []
    for _ in range(2):
        many, _ = sc.make_epoch(rng, 64, 8, 8192)
        epochs.append(from_numpy(np.stack([
            np.concatenate([m[f"tenant_{t:02d}"] for m in many])
            for t in range(64)]), dev))
    tables = zeros((64, 2, spec.storage_width), spec.storage_dtype, dev)
    ops.update_many(tables, spec, epochs[0], [0, 0])
    skeys, mult = sk.dedup_weighted(epochs[1], torch.ones(
        epochs[1].shape, dtype=torch.float32, device=dev))
    keys = ops.as_device_keys(skeys, dev)
    before = tables.clone()
    kw = dict(seeds=ops._seeds_tuple(spec), width=spec.width,
              counter=spec.counter)
    buf = (ctypes.c_ulonglong * 16)()
    times = []
    for _ in range(11):
        tables.copy_(before)
        torch.cuda.synchronize()
        if lib.cml_stamps_read(ctypes.addressof(buf), 1):
            raise RuntimeError("stamps reset failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ksk.fused_update(tables, keys, mult, [0, 1], **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    if lib.cml_stamps_read(ctypes.addressof(buf), 0):
        raise RuntimeError("stamps read failed")
    per_block = {n: v / 64 for n, v in zip(NAMES, buf)}
    chunks = per_block["chunks"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "label": label, "card": card, "kernel5_ms": times[1:],
        "per_block_cycles": per_block,
        "per_chunk_cycles": {n: per_block[n] / chunks for n in NAMES[3:9]}
        if chunks else {}}), flush=True)


if __name__ == "__main__":
    main()
