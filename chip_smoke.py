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
  9. admission and snapshots -- the tracked service of phase 3 with the
                launcher's emb_ids policy (`serve_counts.EMB_IDS`) on every
                tenant: 8 full-size `enqueue_many`, then `admit` of 8,192
                Zipf ids a tenant (the first flushes: kernel 2), equal to
                the plain engine's and to `rows_of` of each `topk_row`; the
                32-tenant windowed service (1 GiB leaf) with the policy,
                through 4 epochs of phase 6's stream and one pending
                microbatch, then `admit` with n_buckets=5 and gamma=0.8
                (kernels 6 and 9), equal to the plain engine's; `admit` on
                clean tracked and windowed planes under
                set_sync_debug_mode("error"); `observe_and_admit` on one
                4 MiB CMLS16 table and 65,536 Zipf ids, engine "kernel"
                (kernels 5 and 1) equal to "xla"; p50 / p95 of `admit`;
                then each service, with pending ring events, snapshot
                into a temporary directory and restored: every leaf equal
                byte for byte, `query_all`, `topk` (and the windowed
                `query`) equal, equal leaves after the same further
                traffic and a flush on both (kernels 1-4 and 6-9 launched
                by the restored services), `packed=True` answers
                bit-identical, `track_top` 32 and 128 give
                `resize_stacked` of the saved trackers; snapshot and
                restore seconds and GiB/s, peak device memory;
 10. tiering -- TierSpec(max_hot_tenants=8) at full size: (a) the tracked
                service of phase 3 (32 MiB of hot tables on the card, a
                256 MiB cold store on the host) beside the untiered one,
                in interleaved timed pairs, through 4 epochs of each
                regime (hot-only: the 8 hot tenants active; all: 64
                active, 56 spill; churn: a 16-tenant working set shifting
                by 8, so tenants swap), every flush's dispatch audit
                checked ({update_score_rows: 1}, + tier_spill a cold fill
                class, + tier_demote and tier_promote on a swap); (b) the
                windowed service of phase 6 (an (8, 8, 2, 1,048,576) hot
                leaf, a 1 GiB cold store) through phase 6's 12-epoch
                stream beside the untiered one; both equal to the
                untiered services (stacked_tables, query_all, query with
                n_buckets / gamma / max, every topk) and, every leaf, to
                the tiered services on the plain engine; (c) a hot-only
                tracked and windowed epoch and enqueue_many reaching cold
                tenants under set_sync_debug_mode("error"); (d) both
                tiered services snapshot with pending events and restored
                (leaves and manifest equal, answers equal, equal after
                the next flush, packed=True bit-identical); events/s and
                median time ratio tiered/untiered per regime, spill
                bytes, promotions, demotions, peak device bytes,
                tier_memory_bytes and the host bytes each tiered plane
                pins, snapshot and restore GiB/s;
 11. algebra and probe -- at full width (width 1,048,576, depth 2):
                (a) decayed_init(history=8) (a (9, 2, 1,048,576) leaf) in
                every format through 12 decayed_update of 65,536 Zipf
                keys, then decayed_query of 1,024 probes, ONE kernel-7
                launch equal to engine="plain"; (b) a window_init ring
                of 8 buckets (CMLS16 and CMS32) through window_update,
                window_rotate and window_advance_to (a jump past the
                ring included), window_query full / n_buckets=3 /
                gamma=0.8 / max equal to the plain engine; (c) merge
                (max, estimate_sum), decay, update_exact on 8,192 events
                and the damped update_batched on the card, each against
                the same port function on the CPU (equal cell for cell in
                every format; estimate-space
                sums of merge and decay within 5 standard deviations of
                the stochastic re-encode), update_exact
                events/s; (d) the tracked service of phase 3 with an
                AccuracyProbe(rate=0.05, capacity=4096) through 8
                enqueue_many (under set_sync_debug_mode("error")) and a
                flush: shadow counts and ARE deciles equal the plain
                engine's; record seconds and the median host-time ratio
                of an epoch with / without the probe in interleaved
                pairs; (e) to_prometheus / to_chrome_trace of the
                phase's registry and tracer written and parsed back;
                decayed_rotate and decayed_query times;
 13. paper path -- merge(estimate_sum) / decay card against CPU at
                (2, 1,048,576), topk.refresh (0 estimate bits apart card
                / CPU), the Fig. 1 ARE sweep of `PaperSketchConfig`, the
                three examples card == CPU, every sharded function at
                world size 1 on NCCL;
 18. card against CPU -- after 13: the tracked and the windowed service
                (CMLS16 at 4 MiB, the emb_ids admission policy on every
                tenant; CPU_TENANTS tenants each, CPU_EPOCHS epochs of
                8 x 8,192 keys a tenant, windowed at rotating event
                times) driven on the card and on the CPU from one seed:
                every leaf, query_all, the windowed reads (full window,
                n_buckets=3, max, gamma=0.9), topk and admit rows and
                masks equal bit for bit;
 14. recsys -- the sketch-gated recommender path, TF32 off: (a) 12
                `dlrm_batch`es of 65,536 x 26 Criteo-field ids (the port's
                Prefetcher) counted in one 4 MiB CMLS16 sketch through
                `observe_and_admit` with `AdmissionSpec()`, engine
                "kernel" (kernels 5 and 1) equal to "xla" at every step
                (tables, rows, masks); (b) dlrm-mlperf's widths (2,368,897
                dense parameters) on 26 admission-gated tables of
                1,049,600 rows (13.01 GiB) trained 12 steps on (a)'s rows
                through `make_train_step`: finite losses, untouched rows
                bit-identical, peak device memory below 60 GiB; then
                3 steps at batch 512 on 5,120-row tables card against
                CPU; (c) `admit` + `dlrm_apply` at serve_p99 and
                serve_bulk (p50 / p95 of 50 calls), `dlrm_score_candidates`
                over 1,000,000 candidates, slices card against CPU; (d)
                two-tower at its full widths, 5 steps at batch 8,192 with
                the sketch's logQ (kernels 5 and 1), 1,000,000 candidates
                scored, slices and a small twin card against CPU; (e)
                `examples/recsys_admission_torch.py` card == CPU;
 15. LM scaffold -- before phase 14 (whose drives keep 13 GiB of DLRM
                tables alive for phase 12), TF32 off, no kernel on its path
                (its launch counts are read and must stay 0 or more): (a)
                qwen2-0.5b at its full config (494,032,768 float32
                parameters, bf16 activations): 5 AdamW steps through
                `make_train_step` at train_4k's sequence of 4,096, batch
                cut from 256 to 4 (peak below 60 GiB with what earlier
                phases leave live), the
                500k-token Zipf corpus (finite, falling losses; step ms,
                tokens/s, model FLOP/s, peak); prefill 8 x 2,048 then 64
                greedy decodes, the prefill's and every decode's logits
                within 5e-2 of one `apply` over the same tokens
                (tests/test_models_smoke.py's bf16 tolerance); prefill
                2 x 30,720 into decode_32k's 32,768-slot cache (batch cut
                from 128) with chunk_q 2,048, then 16 decodes; (b)
                phi3-mini (2 layers), gemma2-27b (2: local and global),
                llama4-scout (4: three chunked, one global; 40.5 GiB of
                float32 weights) and deepseek-v2-lite (the dense prefix
                and 2) at their published widths, each alone: prefill
                2 x 512, 16 decodes, checked against `apply` as in (a);
                the two MoE configs are timed as published and checked
                in float32 with a capacity no token overflows (a decode's
                2 tokens and `apply`'s 1,056 get different capacities,
                and a bf16 rounding can flip a routing decision); (c) the
                seven smoke configs from the same float32 weights card
                against CPU: logits, loss, gradients, the prefill cache,
                four decodes, SASRec / BERT4Rec encodings, losses,
                gradients and `topk_over_catalog` ids (1e-5, gradients
                1e-4, ids exact); (d) SASRec and BERT4Rec at their full
                configs (1,000,000 items): 3 train steps at batch 32,768
                and 8,192 (train_batch's 65,536 cut, see SEQREC_BATCH),
                `topk_over_catalog` at serve_p99 (512 users, k 100) equal
                to a top-k of the whole catalog's scores,
                `score_candidates` over 1,000,000 candidates; (e)
                `launch/train.main --preset 100m --steps 30 --batch 32
                --seq 1024 --sketch` (steps cut from 300), its sketch
                against a CPU `update_batched` of the same batches (equal
                cell for cell), `launch/serve.main
                --arch qwen2-0.5b`, `examples/train_lm_torch.py --preset
                25m --steps 20 --sketch`;
 16. graph and routed -- after phase 15, before 14, TF32 off, no kernel
                on its path: (a) DimeNet at its full config (6 blocks,
                d_hidden 128, 8 bilinear, 7 x 6 bases) trained 5 steps
                through `make_train_step` (OptimizerConfig() with no
                warmup) in the four GNN_SHAPES regimes: molecule (128
                graphs x 30 nodes x 64 edges), full_graph_sm (2,708 nodes,
                10,556 edges padded to 10,752, 1,433 features), minibatch_lg
                (a fresh 1,024-seed (15, 10) subgraph of 169,984 nodes and
                168,960 edges each step from a `synthetic_graph` of the
                published 232,965 nodes and 114,615,892 edges) and
                ogb_products (2,449,029 nodes, edges cut to OGB_EDGES);
                zero-length edges masked, node labels a fixed projection
                of the features; losses finite and falling, step ms
                (first, steady), edges/s, model FLOP/s, peak above live
                below 60 GiB; the smoke configs card against CPU; (b) at
                world size 1 on NCCL: route / send_back with drops,
                `moe_apply_a2a` == `moe_apply` at deepseek-v2-lite's MoE
                widths on 8,192 float32 tokens, `compressed_allreduce_mean`
                of 64 MiB == dequantize(quantize(g)), `dlrm_lookup_a2a` ==
                `dlrm_lookup` on (c)'s tables, `loss_fn_sharded` ==
                `loss_fn`; (c) `dlrm_train_step_sparse` at dlrm-mlperf's
                widths on 26 tables of 1,049,600 rows (13.01 GiB), 12
                steps of 65,536: untouched rows bit-identical, step ms
                and peak, one step card against CPU;
 17. GSPMD placement and the dry run -- after 16, before 14, TF32 off, no
                kernel on its path: (a) `launch/train.main --full --mesh`
                (qwen2-0.5b at its full config on a (1, 1) ("data",
                "model") mesh over a one-rank NCCL group, parameters
                placed by `tree_shardings`, the steps on DTensors) against
                `launch/train.main --full` unmeshed, both 5 steps of
                phase 15's 4 x 4,096 from the same seed and batches:
                losses within 1e-5 relative, parameters within 1e-4
                normwise, ms a step beside phase 15's; (b)
                `launch/serve.main --mesh` == `launch/serve.main`, token
                for token; (c) in a subprocess that never touches the
                card, `launch/dryrun.run_cell` of one cell of each family
                (qwen2-0.5b decode_32k, dlrm-mlperf serve_p99, dimenet
                molecule: DRYRUN_CELLS) on both production meshes, as
                rank 0 of a fake group of 256 / 512, each ok; (d) in the
                same subprocess, the H100 roofline at world size 1
                (`roofline/op_stats`
                on fake tensors) of phase 15's qwen2-0.5b step, phase
                16's DimeNet minibatch_lg step (its first subgraph's
                sizes) and phase 14's DLRM step: each bound, held against
                its phase's measured median step after phase 14, must
                not exceed it (the ratios are printed);
 12. profiles -- last, since a torch.profiler session slows the process's
                later host work: one tracked and one windowed epoch
                (device busy and idle share, synchronizes and copies
                counted), one tracked and one windowed `admit` (their
                launches, copies and synchronizes), every kernel's time
                alone (its profiler
                duration), the card's random-read floor of kernels 7-9
                (each distinct word a call reads, read once in random
                order by one index kernel: tools/time_read_kernels.py),
                one epoch of each tiered regime (hot-only, all, churn)
                and one tiered windowed epoch (synchronizes, copies,
                cudaLaunchKernel), kernel 7 alone on phase 11's decayed
                leaf, phase 14's recsys drives, a qwen2-0.5b train step
                (4 x 4,096), a prefill (8 x 2,048) and a decode step on
                its cache (phase 15's path, built anew here), one DimeNet
                minibatch_lg train step (phase 16's), then the append
                wrappers' host time again.

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
    and setup for the kernel-alone profile of phase 12."""
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
    h2d = sum(c for key, _, c in device_rows if "HtoD" in key)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3), "runtime_calls": calls,
            "host_to_device_copies": h2d,
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
    the profile of phase 12)."""
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
    # call reads, once, in random order (timed alone in phase 12)
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


# ---- phase 9 of slice 7: admission and snapshot/restore ---------------------

ADMIT_CALLS = 200          # admit calls timed a path (p50 / p95)
ADMIT_EPOCHS = 4           # windowed epochs before the windowed admits


def flat_leaves(svc) -> dict:
    from repro_torch.convert import service_to_numpy
    from repro_torch.train.checkpoint import flatten
    return flatten(service_to_numpy(svc)[1])


def compare_leaves(a: dict, b: dict, what: str) -> None:
    if list(a) != list(b):
        fail(f"{what}: leaf names differ: {list(a)} != {list(b)}")
    for k in a:
        if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
            fail(f"{what}: leaf {k} differs ({a[k].dtype} vs {b[k].dtype}, "
                 f"{int(np.sum(a[k] != b[k]))} entries)")


def check_admits(got, want, what: str) -> None:
    for name, (ra, ma) in got.items():
        rb, mb = want[name]
        if not (ra.device == ma.device == rb.device
                and ra.dtype == torch.int32 and ma.dtype == torch.bool):
            fail(f"{what}: admit({name}) returned {ra.device} {ra.dtype}, "
                 f"{ma.device} {ma.dtype}")
        if not (torch.equal(ra, rb) and torch.equal(ma, mb)):
            fail(f"{what}: admit({name}) differs from the plain engine's "
                 f"({int((ma != mb).sum())} decisions, "
                 f"{int((ra != rb).sum())} rows)")


def admit_ids(rng, tenants: int, offset_of) -> dict:
    """BATCH Zipf(1.3) ids a tenant, in its own key universe."""
    return {t: ((rng.zipf(1.3, BATCH) % 10_000)
                + offset_of(t)).astype(np.uint32) for t in range(tenants)}


def tracked_admission(dev, spec, aspec):
    """(a): the tracked service of phase 3 with the emb_ids policy on
    every tenant, 8 enqueue_many microbatches (the rings full, nothing
    flushed), then admit of BATCH ids a tenant (the first flushes the
    plane: kernel 2); kernels and plain engine, rows and masks equal, and
    equal to `rows_of` recomputed from `topk_row`."""
    from repro_torch.core import admission as adm
    from repro_torch.core.counters import from_numpy
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    rng = np.random.default_rng(SEED + 9)
    many, _ = sc.make_epoch(rng, TENANTS, MICRO, BATCH)
    ids = admit_ids(rng, TENANTS, lambda t: t * 1_000_000)
    names = [f"tenant_{t:02d}" for t in range(TENANTS)]

    def drive(engine: str):
        svc = sc.build_service(spec, TENANTS, RING, SEED, TRACK_TOP,
                               device=dev, engine=engine, admission=aspec)
        for events in many:
            svc.enqueue_many(events)
        got = {n: svc.admit(n, ids[t]) for t, n in enumerate(names)}
        torch.cuda.synchronize()
        return svc, got

    ksk.reset_kernel_launches()
    svc, got = drive("auto")
    launches = ksk.kernel_launches()
    psvc, pgot = drive("plain")
    check_admits(got, pgot, "tracked admission")
    compare_services(svc, psvc, "tracked admission")
    plane = svc.planes[0]
    for t, n in enumerate(names):
        keys, est, filled = plane.topk_row(t)
        hot = keys[filled & (est >= aspec.threshold)]
        mask = np.isin(ids[t], hot)
        rows = adm.rows_of(from_numpy(ids[t], dev),
                           torch.from_numpy(mask).to(dev), aspec)
        if not (np.array_equal(mask, got[n][1].cpu().numpy())
                and torch.equal(rows, got[n][0])):
            fail(f"tracked admission: admit({n}) != rows_of of its topk_row")
    if not launches["fused_update_score"]:
        fail(f"tracked admission launched no fused_update_score: {launches}")
    share = float(np.mean([float(m.float().mean()) for _, m in got.values()]))
    log(f"tracked admission: {TENANTS} tenants x {BATCH} ids, admitted "
        f"share {share:.4f}; rows and masks equal the plain engine's and "
        f"rows_of of each topk_row; launches {launches}")
    return svc, psvc, ids, launches


def windowed_admission(dev, spec, aspec, stream):
    """(b): the 32-tenant windowed service (1 GiB leaf) with the emb_ids
    policy on every tenant through ADMIT_EPOCHS epochs of phase 6's
    stream plus one pending microbatch; then admit of BATCH ids a tenant
    with n_buckets=5 (the first flushes: kernel 6; each re-scores the
    heap: kernel 9), and again with gamma=0.8; equal to the plain
    engine."""
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    rng = np.random.default_rng(SEED + 10)
    names = sc.trending_names(WINDOW_TENANTS)
    ids = admit_ids(rng, WINDOW_TENANTS, lambda t: t * 1_000_000)
    pending = stream[ADMIT_EPOCHS][1][0]

    def drive(engine: str):
        svc = sc.build_service(spec, 0, RING, SEED, TRACK_TOP, device=dev,
                               engine=engine, trending=WINDOW_TENANTS,
                               admission=aspec)
        for many, pairs in stream[:ADMIT_EPOCHS]:
            drive_window_epoch(svc, many, pairs)
        svc.enqueue_many(*pending)
        got = {}
        for kw in ({"n_buckets": 5}, {"gamma": 0.8}):
            for t, n in enumerate(names):
                got[(n, *kw)] = svc.admit(n, ids[t], **kw)
        torch.cuda.synchronize()
        return svc, got

    ksk.reset_kernel_launches()
    svc, got = drive("auto")
    launches = ksk.kernel_launches()
    psvc, pgot = drive("plain")
    check_admits(got, pgot, "windowed admission")
    compare_services(svc, psvc, "windowed admission")
    missing = [k for k in ("fused_update_rows", "window_query_stacked_rows")
               if not launches[k]]
    if missing:
        fail(f"windowed admission launched none of {missing}: {launches}")
    share = float(np.mean([float(m.float().mean()) for _, m in got.values()]))
    log(f"windowed admission: {WINDOW_TENANTS} tenants x {BATCH} ids, "
        f"n_buckets=5 and gamma=0.8, admitted share {share:.4f}; equal to "
        f"the plain engine's; launches {launches}")
    return svc, psvc, ids, launches


def admit_no_sync(tsvc, tplain, tids, wsvc, wplain, wids) -> None:
    """(e): admit on a clean tracked and a clean windowed plane under
    torch.cuda.set_sync_debug_mode("error"), equal to the plain engine."""
    t, w = TENANTS - 1, WINDOW_TENANTS - 1
    calls = [("tenant_00", tsvc, tplain, tids[0], {}),
             (f"tenant_{t:02d}", tsvc, tplain, tids[t], {}),
             ("trending_00", wsvc, wplain, wids[0], {"n_buckets": 5}),
             (f"trending_{w:02d}", wsvc, wplain, wids[w], {"gamma": 0.8}),
             ("trending_01", wsvc, wplain, wids[1], {})]
    for name, s, _, _, _ in calls:
        if s._lookup(name)[0].pending():
            fail(f"sync-free admit: {name}'s plane has pending events")
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    got, name = {}, None
    try:
        for name, s, _, ids, kw in calls:
            got[name] = s.admit(name, ids, **kw)
    except RuntimeError as err:
        fail(f"admit({name}) synchronized under set_sync_debug_mode"
             f"('error'): {err}")
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    want = {name: p.admit(name, ids, **kw) for name, _, p, ids, kw in calls}
    check_admits(got, want, "sync-free admit")
    log("sync-free admit: tracked and windowed (full window, n_buckets=5, "
        "gamma=0.8) on clean planes under set_sync_debug_mode('error'), no "
        "error; equal to the plain engine's")


def observe_and_admit_check(dev, spec, aspec):
    """(c): observe_and_admit on one 4 MiB CMLS16 table and 65,536 Zipf
    ids, engine "kernel" (kernels 5 and 1) against "xla"."""
    from repro_torch.core import admission as adm
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import signed_view
    from repro_torch.kernels import sketch as ksk
    rng = np.random.default_rng(SEED + 11)
    ids = (rng.zipf(1.3, RING) % 100_000).astype(np.uint32)
    key = np.asarray([SEED, 99], np.uint32)
    out = {}
    launches = None
    for engine in ("kernel", "xla"):
        if engine == "kernel":
            ksk.reset_kernel_launches()
        out[engine] = adm.observe_and_admit(sk.init(spec, dev), ids, key,
                                            aspec, engine=engine)
        torch.cuda.synchronize()
        if engine == "kernel":
            launches = ksk.kernel_launches()
    (sa, ra, ma), (sb, rb, mb) = out["kernel"], out["xla"]
    if not (torch.equal(signed_view(sa.table), signed_view(sb.table))
            and torch.equal(ra, rb) and torch.equal(ma, mb)):
        fail("observe_and_admit: engine 'kernel' differs from 'xla' "
             f"({int((signed_view(sa.table) != signed_view(sb.table)).sum())}"
             f" cells, {int((ma != mb).sum())} decisions)")
    if launches["fused_update"] != 1 or launches["fused_query"] != 1:
        fail(f"observe_and_admit 'kernel' launches {launches}")
    log(f"observe_and_admit: {RING} ids on one {spec.memory_bytes} B table, "
        f"engine 'kernel' equals 'xla' (table, rows, mask; "
        f"{int(ma.sum())} admitted); launches {launches}")
    return launches


def snapshot_restore(dev, svc, what: str, more, probes, topk_names,
                     query=None, rearm: bool = True) -> dict:
    """(d) for one full-size service with pending ring events: snapshot
    into a temporary directory, restore into a fresh service (every leaf
    equal byte for byte), then query_all and topk equal and, after the
    same `more()` traffic and a flush on both, equal leaves (the PRNG
    lanes carried over); restore with packed=True (query_all
    bit-identical) and with track_top 32 and 128 (the trackers are
    `resize_stacked` of the saved ones).  Returns times, sizes and the
    kernel launches of the restored services' reads and flushes."""
    import tempfile
    from repro_torch.core import topk
    from repro_torch.core.counters import from_numpy
    from repro_torch.kernels import sketch as ksk
    from repro_torch.stream import CountService
    if not svc.dirty_planes:
        fail(f"{what} snapshot: no pending ring events")
    saved = flat_leaves(svc)
    nbytes = sum(a.nbytes for a in saved.values())
    out = {"bytes": nbytes}
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.snapshot(root, step=1)
        out["snapshot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = CountService.restore(root, device=dev)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        compare_leaves(saved, flat_leaves(back), f"{what} restore")
        if back._meta() != svc._meta():
            fail(f"{what} restore: the manifest metadata differs")
        want = svc.query_all(probes)
        tops = {n: svc.topk(n) for n in topk_names}
        one = None if query is None else svc.query(*query)
        torch.cuda.synchronize()
        # the restored service's reads and its next flush, counted alone
        ksk.reset_kernel_launches()
        got = back.query_all(probes)
        reads = {n: back.topk(n) for n in topk_names}
        got_one = None if query is None else back.query(*query)
        more(back)
        back.flush()
        torch.cuda.synchronize()
        launches = ksk.kernel_launches()
        more(svc)
        svc.flush()
        for n in want:
            if not torch.equal(want[n], got[n]):
                fail(f"{what} restore: query_all[{n}] differs")
        for n in topk_names:
            a, b = tops[n], reads[n]
            if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
                fail(f"{what} restore: topk({n}) differs")
        if query is not None and not torch.equal(one, got_one):
            fail(f"{what} restore: query{query[:1]} differs")
        compare_leaves(flat_leaves(svc), flat_leaves(back),
                       f"{what} restore, after the next flush")
        del back
        packed = CountService.restore(root, device=dev, packed=True)
        if not packed.spec_of(topk_names[0]).packed:
            fail(f"{what} restore(packed=True) is not packed")
        got = packed.query_all(probes)
        for n in want:
            if not torch.equal(want[n], got[n]):
                fail(f"{what} restore(packed=True): query_all[{n}] differs")
        del packed
        for k in (TRACK_TOP // 2, TRACK_TOP * 2) if rearm else ():
            re = CountService.restore(root, device=dev, track_top=k)
            for i, p in enumerate(re.planes):
                pre = f"{'windows' if i >= len(re._planes) else 'planes'}/" \
                      f"{i if i < len(re._planes) else i - len(re._planes)}"
                tk = topk.TopK(
                    keys=from_numpy(saved[pre + "/topk/keys"], dev),
                    estimates=from_numpy(saved[pre + "/topk/estimates"], dev),
                    filled=from_numpy(saved[pre + "/topk/filled"], dev))
                want_tk = topk.resize_stacked(tk, k)
                if not (torch.equal(p.tracker.keys.view(torch.int32),
                                    want_tk.keys.view(torch.int32))
                        and torch.equal(p.tracker.estimates,
                                        want_tk.estimates)
                        and torch.equal(p.tracker.filled, want_tk.filled)
                        and p.tracker.keys.shape[1] == k):
                    fail(f"{what} restore(track_top={k}): plane {i}'s "
                         "tracker is not resize_stacked of the saved one")
            del re
    out["snapshot_gib_s"] = nbytes / out["snapshot_s"] / 2**30
    out["restore_gib_s"] = nbytes / out["restore_s"] / 2**30
    log(f"{what} snapshot/restore: {nbytes} B of leaves; snapshot "
        f"{out['snapshot_s']:.3f} s ({out['snapshot_gib_s']:.3f} GiB/s), "
        f"restore {out['restore_s']:.3f} s ({out['restore_gib_s']:.3f} "
        "GiB/s); every leaf and the manifest (tier membership included) "
        "equal, query_all / topk equal, equal after the next flush; "
        "packed=True answers bit-identical"
        + (f"; track_top {TRACK_TOP // 2} and {TRACK_TOP * 2} give "
           "resize_stacked" if rearm else "")
        + f"; launches of the restored service's reads and flush {launches}")
    out["launches"] = launches
    return out


def admit_latency(svc, names, ids, kw) -> dict:
    """p50 / p95 ms of `admit` on a clean plane (after 5 warm-up calls):
    host clock around one call that ends in torch.cuda.synchronize()."""
    out = []
    for i in range(ADMIT_CALLS + 5):
        t = i % len(names)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.admit(names[t], ids[t], **kw)
        torch.cuda.synchronize()
        if i >= 5:
            out.append((time.perf_counter() - t0) * 1e3)
    return {"n": len(out), "p50": float(np.percentile(out, 50)),
            "p95": float(np.percentile(out, 95))}


def admission_phase(dev, spec, stream):
    """Phase 9: admission and snapshot/restore at full size.  Returns
    (kernel launches summed over its paths, the numbers it reports, the
    drives of one tracked and one windowed admit for phase 12's
    profile)."""
    from repro_torch.launch import serve_counts as sc
    aspec = sc.EMB_IDS
    tsvc, tplain, tids, l_a = tracked_admission(dev, spec, aspec)
    wsvc, wplain, wids, l_b = windowed_admission(dev, spec, aspec, stream)
    admit_no_sync(tsvc, tplain, tids, wsvc, wplain, wids)
    del tplain, wplain
    l_c = observe_and_admit_check(dev, spec, aspec)
    tnames = [f"tenant_{t:02d}" for t in range(TENANTS)]
    wnames = sc.trending_names(WINDOW_TENANTS)
    res = {"admit_ms_tracked": admit_latency(tsvc, tnames, tids, {}),
           "admit_ms_windowed": admit_latency(wsvc, wnames, wids,
                                              {"n_buckets": 5})}
    log(f"admit ms ({BATCH} ids, clean plane, host clock to "
        f"synchronize, {ADMIT_CALLS} calls): tracked "
        f"{res['admit_ms_tracked']}, windowed n_buckets=5 "
        f"{res['admit_ms_windowed']}")

    rng = np.random.default_rng(SEED + 12)
    tmore, _ = sc.make_epoch(rng, TENANTS, 2, BATCH)
    tsvc.enqueue_many(tmore[0])  # pending at the snapshot
    res["tracked"] = snapshot_restore(
        dev, tsvc, "tracked", lambda s: s.enqueue_many(tmore[1]),
        sc.probes_for(TENANTS, PROBES)[0], tnames[:4] + ["metrics_qps"])
    nxt = stream[ADMIT_EPOCHS][1]
    wsvc.enqueue_many(*nxt[1])  # pending at the snapshot
    res["windowed"] = snapshot_restore(
        dev, wsvc, "windowed", lambda s: s.enqueue_many(*nxt[2]),
        sc.probes_for(0, PROBES, WINDOW_TENANTS)[2],
        wnames[:4] + ["metrics_qps"],
        query=("trending_02", sc.probes_for(0, PROBES, WINDOW_TENANTS)[4]))
    launches = {k: l_a[k] + l_b[k] + l_c[k] + res["tracked"]["launches"][k]
                + res["windowed"]["launches"][k] for k in l_a}
    restored = {k: res["tracked"]["launches"][k]
                + res["windowed"]["launches"][k] for k in l_a}
    missing = [k for k in ("fused_query", "fused_update_score",
                           "queue_append_dense", "fused_update_rows",
                           "window_query", "window_query_stacked",
                           "window_query_stacked_rows") if not restored[k]]
    if missing:
        fail(f"the restored services launched none of {missing}")
    log(f"peak device memory after phase 9 "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    drives = (lambda: tsvc.admit("tenant_01", tids[1]),
              lambda: wsvc.admit("trending_02", wids[2], n_buckets=5))
    return launches, res, drives


# ---- phase 10 of slice 8: hot/cold tiering ----------------------------------

TIER_HOT = 8            # TierSpec(max_hot_tenants=8) on every plane
TIER_EPOCHS = 4         # epochs of each tracked regime
TIER_REGIMES = ("hot_only", "all", "churn")
CHURN_SET = 16          # the churn regime's working set, shifting by 8


class TierPool:
    """MICRO microbatches of BATCH Zipf(1.3) keys for each of the TENANTS
    tenants (each in its own key universe), made once: an epoch of any
    regime is the pool's microbatches of its active tenants, so traffic
    costs no key generation inside a timed or profiled epoch."""

    def __init__(self, rng):
        self.keys = [[((rng.zipf(1.3, BATCH) % 10_000)
                       + t * 1_000_000).astype(np.uint32)
                      for _ in range(MICRO)] for t in range(TENANTS)]

    def epoch(self, tenants) -> list:
        return [{f"tenant_{t:02d}": self.keys[t][i] for t in tenants}
                for i in range(MICRO)]


def regime_tenants(regime: str, e: int, hot=None) -> list:
    """Active tenants of epoch e of a regime: hot_only the hot tier
    (`hot`, tenants 0-7 at registration), all every tenant, churn a
    working set of CHURN_SET that shifts by 8 an epoch."""
    if regime == "hot_only":
        return list(range(TIER_HOT)) if hot is None else list(hot)
    if regime == "all":
        return list(range(TENANTS))
    return [(8 * e + i) % TENANTS for i in range(CHURN_SET)]


def drive_many(svc, many) -> None:
    for events in many:
        svc.enqueue_many(events)
    svc.flush()


def timed_epoch(svc, drive) -> tuple:
    """(seconds, peak device bytes above the start) of one drive, host
    clock to torch.cuda.synchronize()."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    drive()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def tier_counts(svc) -> dict:
    out = {}
    for p in svc.planes:
        if p.tier is None:
            continue
        out[p.label] = {k: int(svc.metrics.counter(k, plane=p.label).value)
                        for k in ("tier_promotions", "tier_demotions",
                                  "tier_spill_events", "tier_spill_bytes")}
    return out


def expected_flush_audit(plane) -> dict:
    """The dispatch audit of the tiered plane's next flush, before its
    swap: update_score_rows one a fill class of active hot tenants,
    tier_spill one a fill class of active cold ones (a swap adds
    tier_demote and tier_promote, one each:
    `benchmarks/check_regression.py:145-160`)."""
    from repro_torch.stream import tiering
    t = plane.tier
    active = np.flatnonzero(t.hfill)
    hot = active[t.slot[active] >= 0]
    cold = active[t.slot[active] < 0]
    want = {}
    if hot.size:
        want["update_score_rows"] = len(tiering.fill_classes(t.hfill, hot,
                                                             t.capw))
    if cold.size:
        want["tier_spill"] = len(tiering.fill_classes(t.hfill, cold, t.capw))
    return want


def median_time_ratio(tiered_rates, untiered_rates) -> float:
    """The median over interleaved pairs of tiered epoch time / untiered
    epoch time, from their events/s on the same traffic (the reference's
    target for hot-only traffic: <= ~1.1,
    `benchmarks/bench_tiered.py:69-78`; reported, not gated)."""
    return float(np.median([u / t for t, u in zip(tiered_rates,
                                                  untiered_rates)]))


def counted(fn, launches: dict):
    """fn()'s result, its kernel launches added into `launches`."""
    from repro_torch.kernels import sketch as ksk
    ksk.reset_kernel_launches()
    out = fn()
    for k, v in ksk.kernel_launches().items():
        launches[k] += v
    return out


def compare_tiered(tiered, resident, probes, what: str, names,
                   launches: dict) -> None:
    """Tiered against untiered: every plane's `stacked_tables` equal to
    the untiered tables, `query_all` and every listed tenant's `topk`
    equal, bit for bit.  The tiered service's reads add their kernel
    launches into `launches`."""
    from repro_torch.core.counters import signed_view
    for pt, pr in zip(tiered.planes, resident.planes):
        if not torch.equal(signed_view(pt.stacked_tables()),
                           signed_view(pr.tables)):
            fail(f"{what}: plane {pt.label} stacked_tables differ from the "
                 "untiered tables")
    qa = counted(lambda: tiered.query_all(probes), launches)
    qb = resident.query_all(probes)
    for n in qa:
        if not torch.equal(qa[n], qb[n]):
            fail(f"{what}: query_all[{n}] differs from the untiered service")
    for n in names:
        a = counted(lambda: tiered.topk(n), launches)
        b = resident.topk(n)
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            fail(f"{what}: topk({n}) differs from the untiered service")


def tiered_tracked(dev, spec, tspec, pool):
    """(a): the 64-tenant tracked service of phase 3 tiered at 8 hot
    tenants, beside the untiered one and the tiered one on the plain
    engine, through TIER_EPOCHS epochs of each regime (hot_only, all,
    churn) in interleaved timed pairs, each tiered flush's dispatch
    audit checked; then tiered == untiered and tiered == plain."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    mem = {}
    m0 = torch.cuda.memory_allocated()
    tiered = sc.build_service(spec, TENANTS, RING, SEED, TRACK_TOP,
                              device=dev, tier=tspec)
    m1 = torch.cuda.memory_allocated()
    resident = sc.build_service(spec, TENANTS, RING, SEED, TRACK_TOP,
                                device=dev)
    mem["resident_bytes_tiered"] = m1 - m0
    mem["resident_bytes_untiered"] = torch.cuda.memory_allocated() - m1
    plain = sc.build_service(spec, TENANTS, RING, SEED, TRACK_TOP,
                             device=dev, engine="plain", tier=tspec)
    plane = tiered.planes[0]
    launches = dict.fromkeys(ksk.kernel_launches(), 0)
    report, audits = {}, {}
    for regime in TIER_REGIMES:
        tier_s, res_s, peaks = [], [], [0, 0]
        for e in range(TIER_EPOCHS):
            many = pool.epoch(regime_tenants(regime, e))
            events = sum(b.size for ev in many for b in ev.values())
            promos = int(tiered.metrics.counter(
                "tier_promotions", plane=plane.label).value)
            audit = {}

            def drive_tiered():
                for ev in many:
                    tiered.enqueue_many(ev)
                want = expected_flush_audit(plane)
                with ops.audit_scope() as tally:
                    tiered.flush()
                audit.update(got=dict(tally), want=want)
            pair = [(tiered, drive_tiered),
                    (resident, lambda: drive_many(resident, many))]
            for svc, drive in (pair if e % 2 == 0 else pair[::-1]):
                if svc is tiered:
                    ksk.reset_kernel_launches()
                    s, peak = timed_epoch(svc, drive)
                    tier_s.append(events / s)
                    peaks[0] = max(peaks[0], peak)
                    for k, v in ksk.kernel_launches().items():
                        launches[k] += v
                else:
                    s, peak = timed_epoch(svc, drive)
                    res_s.append(events / s)
                    peaks[1] = max(peaks[1], peak)
            swapped = int(tiered.metrics.counter(
                "tier_promotions", plane=plane.label).value) > promos
            want = dict(audit["want"])
            if swapped:
                want.update(tier_demote=1, tier_promote=1)
            if audit["got"] != want:
                fail(f"tiered {regime} epoch {e}: flush audit "
                     f"{audit['got']} != {want}")
            if regime == "hot_only" and want != {"update_score_rows": 1}:
                fail(f"hot-only epoch {e} was not hot-only: {want}")
            if regime == "all" and "tier_spill" not in want:
                fail(f"all-active epoch {e} spilled nothing")
            if regime == "churn" and e >= 1 and not swapped:
                fail(f"churn epoch {e} swapped nothing")
            audits[f"{regime}_{e}"] = audit["got"]
            drive_many(plain, many)
        ratio = median_time_ratio(tier_s, res_s)
        report[regime] = {"events_per_s_tiered": tier_s,
                          "events_per_s_untiered": res_s,
                          "median_time_ratio": ratio,
                          "peak_bytes_tiered": peaks[0],
                          "peak_bytes_untiered": peaks[1],
                          "tier_counts": tier_counts(tiered)}
        log(f"tiered tracked, {regime}: {TIER_EPOCHS} epochs, events/s "
            f"tiered {[round(x) for x in tier_s]} vs untiered "
            f"{[round(x) for x in res_s]} (interleaved pairs), median "
            f"time ratio tiered/untiered {ratio:.3f}; peak device bytes above "
            f"the start of an epoch tiered {peaks[0]} vs untiered "
            f"{peaks[1]}; tier counters {tier_counts(tiered)}")
    probes = sc.probes_for(TENANTS, PROBES)[0]
    names = [f"tenant_{t:02d}" for t in range(TENANTS)] + ["metrics_qps"]
    compare_tiered(tiered, resident, probes, "tiered tracked", names,
                   launches)
    for n in names:
        plain.topk(n)
    plain.query_all(probes)
    compare_leaves(flat_leaves(tiered), flat_leaves(plain),
                   "tiered tracked: kernels against the plain engine")
    missing = [k for k in ("fused_query", "fused_update_score",
                           "queue_append_dense") if not launches[k]]
    if missing:
        fail(f"the tiered tracked regimes launched none of {missing}")
    log(f"tiered tracked: query_all ({PROBES} probes), every tenant's topk "
        "and stacked_tables equal the untiered service's bit for bit; "
        "tables, cold store, mirrors and trackers equal the tiered service "
        f"on the plain engine; flush audits {audits}; launches {launches}")
    mem.update(report=report, audits=audits)
    return tiered, resident, plain, launches, mem


def tiered_windowed(dev, spec, tspec, stream):
    """(b): the 32-tenant windowed service of phase 6 tiered at 8 hot
    tenants (a (8, 8, 2, 1,048,576) hot leaf, a 1 GiB cold store) through
    phase 6's 12-epoch event-time stream beside the untiered service and
    the tiered one on the plain engine; then query_all, query (n_buckets,
    gamma, max) and topk equal to the untiered service's, and every leaf
    equal to the plain engine's."""
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    m0 = torch.cuda.memory_allocated()
    tiered = sc.build_service(spec, 0, RING, SEED, TRACK_TOP, device=dev,
                              trending=WINDOW_TENANTS, tier=tspec)
    m1 = torch.cuda.memory_allocated()
    resident = sc.build_service(spec, 0, RING, SEED, TRACK_TOP, device=dev,
                                trending=WINDOW_TENANTS)
    mem = {"resident_bytes_tiered": m1 - m0,
           "resident_bytes_untiered": torch.cuda.memory_allocated() - m1}
    plain = sc.build_service(spec, 0, RING, SEED, TRACK_TOP, device=dev,
                             engine="plain", trending=WINDOW_TENANTS,
                             tier=tspec)
    launches = dict.fromkeys(ksk.kernel_launches(), 0)
    tier_s, res_s, peaks = [], [], [0, 0]
    for e, (many, pairs) in enumerate(stream):
        events = sum(b.size for ev in many for b in ev.values()) + sum(
            b.size for ev, _ in pairs for b in ev.values())
        order = [(tiered, tier_s, 0), (resident, res_s, 1)]
        for svc, out, i in (order if e % 2 == 0 else order[::-1]):
            ksk.reset_kernel_launches()
            s, peak = timed_epoch(
                svc, lambda: drive_window_epoch(svc, many, pairs))
            out.append(events / s)
            peaks[i] = max(peaks[i], peak)
            if svc is tiered:
                for k, v in ksk.kernel_launches().items():
                    launches[k] += v
        drive_window_epoch(plain, many, pairs)
    probes = sc.probes_for(0, PROBES, WINDOW_TENANTS)
    wnames = sc.trending_names(WINDOW_TENANTS)
    compare_tiered(tiered, resident, probes, "tiered windowed",
                   wnames + ["metrics_qps"], launches)
    for n in (wnames[0], wnames[TIER_HOT], wnames[-1]):
        for kw in ({"n_buckets": 3}, {"gamma": 0.9}, {"mode": "max"}, {}):
            got = counted(lambda: tiered.query(n, probes[2], **kw),
                          launches)
            if not torch.equal(got, resident.query(n, probes[2], **kw)):
                fail(f"tiered windowed: query({n}, {kw}) differs from the "
                     "untiered service")
    for n in wnames + ["metrics_qps"]:
        plain.topk(n)
    plain.query_all(probes)
    compare_leaves(flat_leaves(tiered), flat_leaves(plain),
                   "tiered windowed: kernels against the plain engine")
    missing = [k for k in ("fused_update", "fused_update_rows",
                           "window_query", "window_query_stacked",
                           "window_query_stacked_rows") if not launches[k]]
    if missing:
        fail(f"the tiered windowed stream launched none of {missing}")
    ratio = median_time_ratio(tier_s, res_s)
    mem.update(events_per_s_tiered=tier_s, events_per_s_untiered=res_s,
               median_time_ratio=ratio,
               peak_bytes_tiered=peaks[0], peak_bytes_untiered=peaks[1],
               tier_counts=tier_counts(tiered))
    log(f"tiered windowed: {len(stream)} epochs, events/s tiered "
        f"{[round(x) for x in tier_s]} vs untiered "
        f"{[round(x) for x in res_s]} (interleaved), median time ratio "
        f"{ratio:.3f}; peak device bytes above an "
        f"epoch's start tiered {peaks[0]} vs untiered {peaks[1]}; tier "
        f"counters {tier_counts(tiered)}; query_all, query (n_buckets, "
        "gamma, max) and topk equal the untiered service's; every leaf "
        f"equals the plain engine's; launches {launches}")
    return tiered, resident, plain, launches, mem


def tier_no_sync(dev, pool, tracked, stream_rng, windowed, ts: float):
    """(c): under torch.cuda.set_sync_debug_mode("error"), a hot-only
    tracked epoch (8 enqueue_many to the hot tenants + flush: audit
    {update_score_rows: 1}), a hot-only windowed epoch (8 enqueue_many
    (ts=) to the 8 hot windowed tenants + flush), and an enqueue_many
    that reaches cold tenants of each service (no flush).  Each service's
    twins (untiered, plain engine) take the same traffic outside the
    mode.  Returns the kernel launches of the tiered services."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    t_svc = tracked[0]
    w_svc = windowed[0]
    hot = [int(x) for x in t_svc.planes[0].tier.slot_tenant]
    cold = [t for t in range(TENANTS) if t not in hot][:TIER_HOT]
    many = pool.epoch(hot)
    mixed = pool.epoch(hot[:4] + cold)[0]
    pairs, ts = sc.make_trending(stream_rng, TIER_HOT, MICRO, BATCH, ts)
    whot = set(sc.trending_names(TIER_HOT))
    wplane = w_svc.planes[-1]
    if any(wplane.tier.slot[wplane.names.index(n)] < 0 for n in whot):
        fail("tiered windowed: trending_00..07 are not all hot")
    wcold = {n: pairs[0][0]["trending_00"] for n in
             sc.trending_names(WINDOW_TENANTS)[TIER_HOT:TIER_HOT + 8]}
    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    step = "tracked hot-only epoch"
    try:
        with ops.audit_scope() as tally:
            for ev in many:
                t_svc.enqueue_many(ev)
        with ops.audit_scope() as ftally:
            t_svc.flush()
        step = "windowed hot-only epoch"
        with ops.audit_scope() as wtally:
            for ev, t in pairs:
                w_svc.enqueue_many(ev, ts=t)
            w_svc.flush()
        step = "enqueue_many reaching cold tenants"
        t_svc.enqueue_many(mixed)
        w_svc.enqueue_many(wcold, ts=ts)
    except RuntimeError as err:
        fail(f"tiered {step} synchronized under set_sync_debug_mode"
             f"('error'): {err}")
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    launches = ksk.kernel_launches()
    if dict(ftally) != {"update_score_rows": 1}:
        fail(f"tiered hot-only flush audit {dict(ftally)}")
    if any(k.startswith("tier_") for k in wtally):
        fail(f"tiered windowed hot-only epoch touched the cold tier: "
             f"{dict(wtally)}")
    for svc in tracked[1:]:
        for ev in many:
            svc.enqueue_many(ev)
        svc.flush()
        svc.enqueue_many(mixed)
    for svc in windowed[1:]:
        for ev, t in pairs:
            svc.enqueue_many(ev, ts=t)
        svc.flush()
        svc.enqueue_many(wcold, ts=ts)
    for what, svcs in (("tracked", tracked), ("windowed", windowed)):
        compare_leaves(flat_leaves(svcs[0]), flat_leaves(svcs[2]),
                       f"sync-free tiered {what}: kernels against plain")
    log("sync-free tiering: a hot-only tracked epoch (enqueue_many "
        f"{dict(tally)}, flush {dict(ftally)}), a hot-only windowed epoch "
        f"({dict(wtally)}) and enqueue_many reaching cold tenants of both, "
        "under set_sync_debug_mode('error'), no error; leaves equal the "
        f"plain engine's; launches {launches}")
    return launches, ts


def tiering_phase(dev, spec, stream):
    """Phase 10: hot/cold tiering at full size, (a)-(d).  Returns (kernel
    launches summed over its paths, the numbers it reports, the drives
    of one profiled epoch of each tracked regime and of the windowed
    stream for phase 12)."""
    from repro_torch.launch import serve_counts as sc
    from repro_torch.stream import TierSpec, tier_memory_bytes
    t0 = time.perf_counter()
    peak_before = torch.cuda.max_memory_allocated()
    tspec = TierSpec(max_hot_tenants=TIER_HOT)
    pool = TierPool(np.random.default_rng(SEED + 13))
    res = {"tier_memory_bytes": {
        "tracked": tier_memory_bytes(spec, tspec, TENANTS),
        "windowed": {k: v * WINDOW_BUCKETS for k, v in tier_memory_bytes(
            spec, tspec, WINDOW_TENANTS).items()}}}
    log(f"tiering: TierSpec(max_hot_tenants={TIER_HOT}) on every plane; "
        f"tier_memory_bytes {res['tier_memory_bytes']}")
    t_svc, t_res, t_plain, l_a, res["tracked"] = tiered_tracked(
        dev, spec, tspec, pool)
    w_svc, w_res, w_plain, l_b, res["windowed"] = tiered_windowed(
        dev, spec, tspec, stream)
    rng = np.random.default_rng(SEED + 14)
    l_c, ts = tier_no_sync(dev, pool, (t_svc, t_res, t_plain), rng,
                           (w_svc, w_res, w_plain), stream[-1][1][-1][1])
    del t_res, t_plain, w_res, w_plain

    # (d) full-size tiered snapshots with pending ring events
    tnames = [f"tenant_{t:02d}" for t in range(TENANTS)]
    wnames = sc.trending_names(WINDOW_TENANTS)
    more_t = pool.epoch(range(0, TENANTS, 4))[0]
    res["snapshot_tracked"] = snapshot_restore(
        dev, t_svc, "tiered tracked", lambda s: s.enqueue_many(more_t),
        sc.probes_for(TENANTS, PROBES)[0],
        tnames[:2] + tnames[-2:] + ["metrics_qps"], rearm=False)
    more_w, ts = sc.make_trending(rng, WINDOW_TENANTS, 1, BATCH, ts)
    wprobes = sc.probes_for(0, PROBES, WINDOW_TENANTS)
    res["snapshot_windowed"] = snapshot_restore(
        dev, w_svc, "tiered windowed",
        lambda s: s.enqueue_many(*more_w[0]), wprobes[2],
        wnames[:2] + wnames[-2:] + ["metrics_qps"],
        query=(wnames[-1], wprobes[4]), rearm=False)
    launches = {k: l_a[k] + l_b[k] + l_c[k]
                + res["snapshot_tracked"]["launches"][k]
                + res["snapshot_windowed"]["launches"][k] for k in l_a}

    # the drives phase 12 profiles: one epoch of each tracked regime on the
    # tiered service as it stands then, and one windowed epoch
    def hot_now() -> list:
        return [int(x) for x in t_svc.planes[0].tier.slot_tenant]

    def cold_set() -> list:
        hot = set(hot_now())
        return [t for t in range(TENANTS) if t not in hot][:CHURN_SET]
    wmany, _ = sc.make_epoch(rng, 0, MICRO, BATCH)
    wpairs, _ = sc.make_trending(rng, WINDOW_TENANTS, MICRO, BATCH, ts)
    drives = {
        "hot_only": lambda: drive_many(t_svc, pool.epoch(hot_now())),
        "all": lambda: drive_many(t_svc, pool.epoch(range(TENANTS))),
        "churn": lambda: drive_many(t_svc, pool.epoch(cold_set())),
        "windowed": lambda: drive_window_epoch(w_svc, wmany, wpairs)}
    res["seconds"] = time.perf_counter() - t0
    res["peak_device_bytes_before"] = peak_before
    # the host memory a tiered plane pins beside its cold store, after the
    # phase's largest cold traffic (uploads of the whole cold store)
    res["pinned_bytes"] = {what: {p.label: p.pinned_bytes for p in svc.planes
                                  if p.tier is not None}
                           for what, svc in (("tracked", t_svc),
                                             ("windowed", w_svc))}
    log(f"tiering phase: {res['seconds']:.1f} s; launches {launches}; "
        f"pinned host bytes per tiered plane {res['pinned_bytes']} beside "
        f"tier_memory_bytes {res['tier_memory_bytes']}")
    return launches, res, drives, (t_svc, w_svc)


# ---- phase 11 of slice 9: the sketch and window algebra, and the probe ------

ALG_HISTORY = 8        # decayed_init(history=8): a (9, 2, 1,048,576) leaf
ALG_UPDATES = 12       # decayed_update calls of ALG_KEYS keys
ALG_KEYS = 65_536
ALG_GAMMA = 0.7
EXACT_EVENTS = 8_192   # update_exact events held card against CPU
DAMP_ALPHA = 0.5
PROBE_RATE = 0.05
PROBE_CAPACITY = 4096
PROBE_PAIRS = 5        # interleaved probe-on / probe-off timed epochs


def zipf_keys(rng, n: int) -> np.ndarray:
    return (rng.zipf(1.3, n) % 1_000_000).astype(np.uint32)


def cells_apart(got, want, spec, what: str) -> int:
    """Card and CPU storage tables of one spec, cell for cell: equal in
    every format (the kernels and plain versions compute one float32
    graph on both devices).  Returns the count of differing cells, 0."""
    from repro_torch.core import sketch as sk
    a = sk.logical_table(got.cpu(), spec)
    b = sk.logical_table(want.cpu(), spec)
    n = int((a != b).sum())
    if n:
        fail(f"{what}: {n} of {a.numel()} cells differ between the card "
             f"and the CPU")
    return n


def estimate_sum(table, spec) -> float:
    from repro_torch.core import sketch as sk
    return float(spec.counter.decode(sk.logical_table(table, spec)).double()
                 .sum())


def unbiased(table, want: float, spec, what: str) -> float:
    """The re-encoded table's estimate-space sum against `want`: a
    stochastic re-encode is unbiased, each cell's error below one point
    mass of its state with variance at most point_mass^2 / 4, so the sum
    must lie within 5 of those standard deviations.  Returns the sum's
    ratio to `want`."""
    from repro_torch.core import sketch as sk
    got = estimate_sum(table, spec)
    pm = spec.counter.point_mass(sk.logical_table(table, spec)).double()
    sigma = float((pm.square().sum() / 4).sqrt())
    if abs(got - want) > 5 * sigma:
        fail(f"{what}: estimate-space sum {got} vs {want} (sigma {sigma})")
    return got / want


def decayed_check(dev, formats, probes) -> tuple:
    """(a): per format, decayed_init(history=8) at full width through
    ALG_UPDATES decayed_update calls of Zipf keys, then decayed_query of
    the probes with kernel 7 (ONE launch) equal to engine="plain".
    Returns (launches, {format: ...}, the CMLS16 leaf for the times)."""
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import sketch as ksk
    from repro_torch.stream import window as wnd
    rng = np.random.default_rng(SEED + 21)
    batches = [torch.from_numpy(zipf_keys(rng, ALG_KEYS).astype(np.int64))
               .to(dev) for _ in range(ALG_UPDATES)]
    out, keep, launches = {}, None, {}
    for fname, counter, packed in formats:
        spec = sk.SketchSpec.from_memory(BUDGET, depth=2, counter=counter,
                                         packed=packed)
        ds = wnd.decayed_init(spec, gamma=ALG_GAMMA, history=ALG_HISTORY,
                              device=dev)
        for i, keys in enumerate(batches):
            ds = wnd.decayed_update(ds, keys, [SEED + 21, i],
                                    age_step=i % 3 != 2)
        torch.cuda.synchronize()
        ksk.reset_kernel_launches()
        got = wnd.decayed_query(ds, probes)
        torch.cuda.synchronize()
        counts = ksk.kernel_launches()
        want = wnd.decayed_query(ds, probes, engine="plain")
        if counts["window_query"] != 1 or sum(counts.values()) != 1:
            fail(f"decayed_query {fname}: kernel launches {counts}, want "
                 "one window_query")
        if not torch.equal(got, want):
            fail(f"decayed_query {fname}: kernel 7 differs from the plain "
                 f"engine (max abs {float((got - want).abs().max())})")
        if not bool(torch.isfinite(got).all()) or float(got.sum()) <= 0:
            fail(f"decayed_query {fname}: answers not finite and positive")
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        out[fname] = {"leaf": list(ds.tables.shape),
                      "leaf_bytes": ds.tables.numel()
                      * ds.tables.element_size(),
                      "answer_sum": float(got.sum())}
        if fname == "CMLS16":
            keep = ds
    log(f"decayed sketch: (history {ALG_HISTORY} + tail) leaves through "
        f"{ALG_UPDATES} decayed_update of {ALG_KEYS} keys; decayed_query of "
        f"{probes.numel()} probes, kernel 7 equal to the plain engine in "
        f"every format: {out}")
    return launches, out, keep


def window_check(dev, spec, fname, probes) -> dict:
    """(b): a window_init ring of WINDOW_BUCKETS buckets through
    window_update / window_rotate / window_advance_to (one interval,
    several, a jump past the whole ring); window_query full, n_buckets=3,
    gamma=0.8 and mode="max" with kernel 7 equal to the plain engine."""
    from repro_torch.kernels import sketch as ksk
    from repro_torch.stream import WindowSpec
    from repro_torch.stream import window as wnd
    rng = np.random.default_rng(SEED + 22)
    wspec = WindowSpec(sketch=spec, buckets=WINDOW_BUCKETS, interval=60.0)
    win = wnd.window_init(wspec, device=dev)
    steps = [30.0, 50.0, None, 130.0, 400.0, None, 420.0,
             420.0 + 60.0 * (WINDOW_BUCKETS + 2), 500.0 + 60.0 * 11]
    for i, ts in enumerate(steps):
        win = (wnd.window_rotate(win) if ts is None
               else wnd.window_advance_to(win, ts))
        keys = torch.from_numpy(zipf_keys(rng, ALG_KEYS).astype(np.int64))
        win = wnd.window_update(win, keys.to(dev), [SEED + 22, i])
    full = int((win.tables.view(torch.uint8) != 0).flatten(1).any(1).sum())
    if win.epoch != 19 or full < 2:
        fail(f"window ring {fname}: epoch {win.epoch}, {full} live buckets")
    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    reads = [("full", {}), ("n_buckets=3", {"n_buckets": 3}),
             ("gamma=0.8", {"gamma": 0.8}), ("max", {"mode": "max"})]
    got = {what: wnd.window_query(win, probes, **kw) for what, kw in reads}
    torch.cuda.synchronize()
    counts = ksk.kernel_launches()
    if counts["window_query"] != len(reads):
        fail(f"window ring {fname}: kernel launches {counts}")
    for what, kw in reads:
        want = wnd.window_query(win, probes, engine="plain", **kw)
        if not torch.equal(got[what], want):
            fail(f"window_query {what} {fname}: kernel 7 differs from the "
                 "plain engine")
    log(f"window ring {fname}: window_init + {len(steps)} updates through "
        f"rotations and watermark advances (epoch {win.epoch}, cursor "
        f"{win.cursor}); window_query full / n_buckets=3 / gamma=0.8 / max "
        "with kernel 7 equal to the plain engine")
    return counts


def algebra_on_card(dev, spec, fname) -> dict:
    """(c): merge, decay, update_exact and the damped update_batched on the
    card, each held against the same port function on the CPU from the
    same inputs.  Returns the differing cells and the rates."""
    from repro_torch.core import sketch as sk
    from repro_torch.stream import window as wnd
    rng = np.random.default_rng(SEED + 23)
    keys_a = torch.from_numpy(zipf_keys(rng, 4 * ALG_KEYS).astype(np.int64))
    keys_b = torch.from_numpy(zipf_keys(rng, 4 * ALG_KEYS).astype(np.int64))
    a = sk.update_batched(sk.init(spec, device=dev), keys_a.to(dev), [1, 1])
    b = sk.update_batched(sk.init(spec, device=dev), keys_b.to(dev), [1, 2])
    a_cpu = sk.Sketch(table=a.table.cpu(), spec=spec)
    b_cpu = sk.Sketch(table=b.table.cpu(), spec=spec)
    res = {}
    m = sk.merge(a, b, mode="max")
    res["merge_max"] = cells_apart(m.table, sk.merge(a_cpu, b_cpu).table,
                                   spec, f"merge max {fname}")
    if res["merge_max"]:
        fail(f"merge max {fname}: card and CPU differ")
    key = [1, 3]
    m = sk.merge(a, b, mode="estimate_sum", rng=key)
    m_cpu = sk.merge(a_cpu, b_cpu, mode="estimate_sum", rng=key)
    res["merge_estimate_sum"] = cells_apart(
        m.table, m_cpu.table, spec, f"merge estimate_sum {fname}")
    ratio = unbiased(m.table, estimate_sum(a.table, spec)
                     + estimate_sum(b.table, spec), spec,
                     f"merge estimate_sum {fname}")
    d = wnd.decay(a, ALG_GAMMA, [1, 4])
    res["decay"] = cells_apart(d.table, wnd.decay(a_cpu, ALG_GAMMA,
                                                  [1, 4]).table,
                               spec, f"decay {fname}")
    decay_ratio = unbiased(d.table, ALG_GAMMA * estimate_sum(a.table, spec),
                           spec, f"decay {fname}")
    res["merge_mean_ratio"], res["decay_mean_ratio"] = ratio, decay_ratio
    ev = torch.from_numpy(zipf_keys(rng, EXACT_EVENTS).astype(np.int64))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e = sk.update_exact(a, ev.to(dev), [1, 5])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_cpu = sk.update_exact(a_cpu, ev, [1, 5])
    dt_cpu = time.perf_counter() - t0
    res["update_exact"] = cells_apart(e.table, e_cpu.table, spec,
                                      f"update_exact {fname}")
    moved = int((sk.logical_table(e.table, spec)
                 != sk.logical_table(a.table, spec)).sum())
    if moved == 0:
        fail(f"update_exact {fname}: no cell moved")
    res["update_exact_events_per_s"] = EXACT_EVENTS / dt
    res["update_exact_events_per_s_cpu"] = EXACT_EVENTS / dt_cpu
    dk = torch.from_numpy(zipf_keys(rng, ALG_KEYS).astype(np.int64))
    dmp = sk.update_batched(a, dk.to(dev), [1, 6], damp_alpha=DAMP_ALPHA)
    und = sk.update_batched(a, dk.to(dev), [1, 6])
    res["damped"] = cells_apart(
        dmp.table, sk.update_batched(a_cpu, dk, [1, 6],
                                     damp_alpha=DAMP_ALPHA).table,
        spec, f"damped update_batched {fname}")
    if torch.equal(dmp.table.view(torch.uint8), und.table.view(torch.uint8)):
        fail(f"damped update_batched {fname}: equal to the undamped update")
    log(f"algebra on the card, {fname}, against the CPU: cells apart "
        f"{ {k: v for k, v in res.items() if isinstance(v, int)} }; "
        f"estimate-space means merge {ratio:.6f}, decay {decay_ratio:.6f}; "
        f"update_exact {res['update_exact_events_per_s']:.0f} events/s on "
        f"the card, {res['update_exact_events_per_s_cpu']:.0f} on the CPU")
    return res


def probe_check(dev, spec, registry, tracer) -> tuple:
    """(d): the 64-tenant tracked service of phase 3 with an
    AccuracyProbe through MICRO full-size enqueue_many and a flush, its
    appends under set_sync_debug_mode("error"), against the same stream
    on the plain engine (which carries the phase's registry and tracer):
    equal shadow counts and ARE deciles.  Then the host time of an epoch
    with the probe over without, in interleaved pairs, and the seconds
    `record` takes.  Returns (launches, report)."""
    from repro_torch import obs
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    rng = np.random.default_rng(SEED + 24)
    many, _ = sc.make_epoch(rng, TENANTS, MICRO, BATCH)

    def build(engine, probe, **kw):
        return sc.build_service(spec, TENANTS, RING, SEED, TRACK_TOP,
                                device=dev, engine=engine, probe=probe, **kw)

    probe = obs.AccuracyProbe(rate=PROBE_RATE, capacity=PROBE_CAPACITY)
    svc = build("auto", probe)
    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for events in many:
            svc.enqueue_many(events)
    except RuntimeError as err:
        fail(f"enqueue_many with the probe synchronized: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    svc.flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ares = probe.record(svc)
    record_s = time.perf_counter() - t0
    launches = ksk.kernel_launches()
    missing = [k for k in ("fused_query", "fused_update_score",
                           "queue_append", "queue_append_dense")
               if launches[k] == 0]
    if missing:
        fail(f"probe path: kernels not launched: {missing}")
    pprobe = obs.AccuracyProbe(rate=PROBE_RATE, capacity=PROBE_CAPACITY)
    plain = build("plain", pprobe, metrics=registry, tracer=tracer)
    for events in many:
        plain.enqueue_many(events)
    plain.flush()
    pares = pprobe.record(plain)
    if probe.counts != pprobe.counts or probe.dropped != pprobe.dropped:
        fail("probe: shadow counts differ between kernels and plain engine")
    if ares != pares:
        fail("probe: ARE deciles differ between kernels and plain engine")
    if len(ares) < TENANTS:
        fail(f"probe: {len(ares)} tenants scored")
    del plain
    shadowed = sum(len(c) for c in probe.counts.values())

    # host time of an epoch with the probe over one without, in pairs
    bare = build("auto", None)
    ratios, times = [], {"probe": [], "bare": []}
    for i in range(PROBE_PAIRS):
        ep, _ = sc.make_epoch(rng, TENANTS, MICRO, BATCH)
        pair = [("probe", svc), ("bare", bare)]
        if i % 2:
            pair.reverse()
        for what, s in pair:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for events in ep:
                s.enqueue_many(events)
            s.flush()
            torch.cuda.synchronize()
            times[what].append(time.perf_counter() - t0)
        ratios.append(times["probe"][-1] / times["bare"][-1])
    res = {"shadowed_keys": shadowed, "dropped": probe.dropped,
           "record_s": record_s, "tenants_scored": len(ares),
           "epoch_s_probe": summary(times["probe"]),
           "epoch_s_bare": summary(times["bare"]),
           "epoch_ratio_median": float(np.median(ratios)),
           "epoch_ratios": ratios,
           "are_tenant_00": ares["tenant_00"]}
    log(f"probe: {TENANTS}-tenant tracked service, AccuracyProbe(rate="
        f"{PROBE_RATE}, capacity={PROBE_CAPACITY}): {shadowed} shadowed "
        f"keys, shadow counts and ARE deciles equal the plain engine's, "
        f"enqueue_many under set_sync_debug_mode('error'); record "
        f"{record_s:.4f} s for {len(ares)} tenants; epoch host time with / "
        f"without the probe, median of {PROBE_PAIRS} interleaved pairs "
        f"{res['epoch_ratio_median']:.4f}; tenant_00 ARE by decile "
        f"{[round(v, 4) for v in ares['tenant_00']]}; launches {launches}")
    del bare, svc
    return launches, res


def export_check(registry, tracer, scored: int) -> dict:
    """(e): the phase's registry and tracer through to_prometheus and
    to_chrome_trace into a temporary directory, parsed back."""
    import tempfile
    from repro_torch import obs
    with tempfile.TemporaryDirectory() as root:
        prom = pathlib.Path(root) / "phase11.prom"
        trace = pathlib.Path(root) / "phase11_trace.json"
        obs.write_prometheus(str(prom), registry)
        obs.write_chrome_trace(str(trace), tracer)
        lines = prom.read_text().splitlines()
        events = json.loads(trace.read_text())["traceEvents"]
    series = {}
    for line in lines:
        if line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        series[key] = float(value)
    deciles = [k for k in series if k.startswith("accuracy_are_decile{")]
    buckets = [k for k in series if k.startswith("span_duration_us_bucket{")]
    if len(deciles) != 10 * scored or not buckets:
        fail(f"export: {len(deciles)} accuracy_are_decile gauges, "
             f"{len(buckets)} span_duration_us buckets")
    names = {ev["name"] for ev in tracer.events}
    back = [ev["name"] for ev in events]
    if sorted(back) != sorted(ev["name"] for ev in tracer.events):
        fail("export: the chrome trace lost spans")
    for key, value in registry.snapshot()["gauges"].items():
        if key.startswith("accuracy_are_decile") and \
                series[key] != value["value"]:
            fail(f"export: {key} parsed back as {series[key]}")
    res = {"series": len(series), "decile_gauges": len(deciles),
           "span_buckets": len(buckets), "spans": len(back),
           "span_names": sorted(names)}
    log(f"export: Prometheus text ({len(series)} series, {len(deciles)} "
        f"accuracy_are_decile gauges, {len(buckets)} span_duration_us "
        f"buckets) and a chrome trace of {len(back)} spans "
        f"({sorted(names)}) written and parsed back")
    return res


def algebra_phase(dev, formats) -> tuple:
    """Phase 11: the sketch and window algebra, the probe and the export
    at full width, (a)-(e).  Returns (kernel launches summed over its
    paths, the numbers it reports, the drives phase 12 times alone)."""
    from repro_torch import obs
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import CMLS16, CMS32, from_numpy
    from repro_torch.stream import window as wnd
    t0 = time.perf_counter()
    res = {}
    probes = from_numpy(np.arange(PROBES, dtype=np.uint32) * 7, dev)
    l_a, res["decayed"], ds = decayed_check(dev, formats, probes)
    launches = dict(l_a)
    specs = {"CMLS16": sk.SketchSpec.from_memory(BUDGET, depth=2,
                                                 counter=CMLS16),
             "CMS32": sk.SketchSpec.from_memory(BUDGET, depth=2,
                                                counter=CMS32)}
    res["algebra"] = {}
    for fname, spec in specs.items():
        for k, v in window_check(dev, spec, fname, probes).items():
            launches[k] += v
        res["algebra"][fname] = algebra_on_card(dev, spec, fname)
    registry = obs.MetricsRegistry()
    tracer = obs.Tracer(enabled=True, metrics=registry)
    l_d, res["probe"] = probe_check(dev, specs["CMLS16"], registry, tracer)
    for k, v in l_d.items():
        launches[k] += v
    res["export"] = export_check(registry, tracer,
                                 res["probe"]["tenants_scored"])

    # times: decayed_rotate and decayed_query on the CMLS16 leaf
    res["decayed_rotate_ms"] = cuda_ms(
        lambda: wnd.decayed_rotate(ds, [SEED, 99]), 10)
    res["decayed_query_ms"] = cuda_ms(lambda: wnd.decayed_query(ds, probes),
                                      50)
    res["decayed_query_plain_ms"] = cuda_ms(
        lambda: wnd.decayed_query(ds, probes, engine="plain"), 10)
    res["seconds"] = time.perf_counter() - t0
    log(f"algebra phase: {res['seconds']:.1f} s; decayed_rotate "
        f"{res['decayed_rotate_ms']:.4f} ms, decayed_query "
        f"{res['decayed_query_ms']:.4f} ms (plain "
        f"{res['decayed_query_plain_ms']:.4f} ms) on the "
        f"{tuple(ds.tables.shape)} CMLS16 leaf; launches {launches}")
    drives = {"decayed_query": lambda: wnd.decayed_query(ds, probes)}
    return launches, res, drives


# ---- phase 13 of slice 10: the repair, the paper's path, sharded at W = 1 ---

REPAIR_WIDTH = 1 << 20   # (2, 1,048,576) tables of the repair check
TOPK_K = 64
TOPK_BATCHES = 16
TOPK_KEYS = 65_536
PAPER_CHUNK = 131_072    # benchmarks/common.py count_stream's chunk
PAPER_TWINS = (32_768, 4_194_304)  # budgets also counted on the CPU
ROUTE_CAP = 1 << 17      # per-rank capacity of the routed calls
ULP8 = 8 * 2.0 ** -23


def random_states(rng, counter, shape) -> np.ndarray:
    """Cell states spread over the whole range, a third of them empty."""
    s = rng.integers(0, counter.max_state + 1, shape, dtype=np.int64)
    s[rng.random(shape) < 1 / 3] = 0
    return s


def repair_check(dev) -> dict:
    """(a): merge(estimate_sum) with a key and without one, and decay, on
    (2, 1,048,576) CMLS16 and CMLS8 tables on the card and on the CPU:
    0 cells apart (the re-encode runs in `core/xla_f32`'s math, the same
    bits on any device).  Then decayed_rotate's ms on a (9, 2, 1,048,576)
    CMLS16 leaf."""
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import CMLS8, CMLS16
    from repro_torch.stream import window as wnd
    rng = np.random.default_rng(SEED + 31)
    res = {}
    for fname, counter in (("CMLS16", CMLS16), ("CMLS8", CMLS8)):
        spec = sk.SketchSpec(width=REPAIR_WIDTH, depth=2, counter=counter)
        host = [sk.Sketch(sk.storage_table(torch.from_numpy(
            random_states(rng, counter, (2, REPAIR_WIDTH))), spec), spec)
            for _ in range(2)]
        card = [sk.Sketch(h.table.to(dev), spec) for h in host]
        apart = {}
        for what, key in (("merge_key", [31, 1]), ("merge_floor", None)):
            got = sk.merge(*card, mode="estimate_sum", rng=key)
            want = sk.merge(*host, mode="estimate_sum", rng=key)
            apart[what] = int((sk.logical_table(got.table.cpu(), spec)
                               != sk.logical_table(want.table, spec)).sum())
        got = wnd.decay(card[0], ALG_GAMMA, [31, 2])
        want = wnd.decay(host[0], ALG_GAMMA, [31, 2])
        apart["decay"] = int((sk.logical_table(got.table.cpu(), spec)
                              != sk.logical_table(want.table, spec)).sum())
        if any(apart.values()):
            fail(f"repair {fname}: cells apart card / CPU {apart}")
        res[fname] = apart
    spec = sk.SketchSpec(width=REPAIR_WIDTH, depth=2, counter=CMLS16)
    ds = wnd.decayed_init(spec, gamma=ALG_GAMMA, history=ALG_HISTORY,
                          device=dev)
    for i in range(ALG_HISTORY + 2):
        keys = torch.from_numpy(zipf_keys(rng, ALG_KEYS).astype(np.int64))
        ds = wnd.decayed_update(ds, keys.to(dev), [31, 10 + i])
    res["decayed_rotate_ms"] = cuda_ms(
        lambda: wnd.decayed_rotate(ds, [31, 99]), 10)
    log(f"repair: merge(estimate_sum) with a key / without, decay on "
        f"(2, {REPAIR_WIDTH}) tables, cells apart card / CPU {res}; "
        f"decayed_rotate {res['decayed_rotate_ms']:.4f} ms on the "
        f"{tuple(ds.tables.shape)} CMLS16 leaf")
    return res


def topk_check(dev) -> dict:
    """(b): a k = 64 tracker over a 4 MiB CMLS16 sketch refreshed by 16
    batches of 65,536 Zipf(1.3) keys, on the card and, from a copy of the
    same table, on the CPU: the same keys, occupancy and estimates, bit
    for bit (the estimates' bits apart are counted: 0)."""
    from repro_torch.core import sketch as sk
    from repro_torch.core import topk
    from repro_torch.core.counters import CMLS16, signed_view
    rng = np.random.default_rng(SEED + 32)
    spec = sk.SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16)
    s = sk.init(spec, device=dev)
    tr_c = topk.init(TOPK_K, device=dev)
    tr_h = topk.init(TOPK_K, device="cpu")
    bits_apart, ms = 0, []
    for i in range(TOPK_BATCHES):
        batch = torch.from_numpy(zipf_keys(rng, TOPK_KEYS).astype(np.int64))
        s = sk.update_batched(s, batch.to(dev), [32, i])
        host = sk.Sketch(s.table.cpu(), spec)
        bd = batch.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr_c = topk.refresh(tr_c, s, bd)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        tr_h = topk.refresh(tr_h, host, batch)
        if not (torch.equal(signed_view(tr_c.keys).cpu(),
                            signed_view(tr_h.keys))
                and torch.equal(tr_c.filled.cpu(), tr_h.filled)):
            fail(f"topk.refresh batch {i}: keys or filled differ card / CPU")
        a, b = tr_c.estimates.cpu(), tr_h.estimates
        bits_apart += int((a.view(torch.int32) != b.view(torch.int32)).sum())
        if bits_apart:
            fail(f"topk.refresh batch {i}: {bits_apart} estimates apart "
                 f"card / CPU")
    if not bool(tr_c.filled.all()):
        fail("topk.refresh: the tracker did not fill")
    res = {"estimate_bits_apart": bits_apart,
           "refresh_ms": summary(ms),
           "top3": [(int(k), float(e)) for k, e in
                    zip(tr_c.keys[:3].cpu().tolist(), tr_c.estimates[:3])]}
    log(f"topk.refresh: k={TOPK_K} over a {spec.memory_bytes} B CMLS16 "
        f"sketch, {TOPK_BATCHES} batches of {TOPK_KEYS} keys: keys and "
        f"filled equal card / CPU, {bits_apart} estimate bits apart of "
        f"{TOPK_BATCHES * TOPK_K}; {res}")
    return res


def paper_sweep(dev) -> dict:
    """(c): the calibrated 500k-token corpus's event stream counted in
    every variant x budget of the port's PaperSketchConfig on the card
    (update_batched in chunks, `benchmarks/common.py count_stream`), ARE
    over the distinct keys through ops.query (kernel 1); the 32 KiB and 4
    MiB sketches of each variant counted on the CPU too (equal cell for
    cell in every variant)."""
    from repro_torch.configs.paper_sketch import CFG
    from repro_torch.core import prng
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import from_numpy
    from repro_torch.data import corpus, ngrams
    from repro_torch.kernels import ops
    toks = corpus.generate(corpus.CorpusSpec())
    events = ngrams.event_stream(toks)
    uniq, true = ngrams.exact_counts(events)
    probes = from_numpy(uniq, dev)
    chunks = [events[i:i + PAPER_CHUNK]
              for i in range(0, len(events), PAPER_CHUNK)]
    keys, rng = [], np.array([0, 0], np.uint32)
    for _ in chunks:
        rng, k = prng.split(rng, 2)
        keys.append(k)
    dev_chunks = [from_numpy(c, dev) for c in chunks]

    def count(spec, device, parts):
        s = sk.init(spec, device=device)
        for c, k in zip(parts, keys):
            s = sk.update_batched(s, c, k)
        return s

    are, apart, t0 = {}, {}, time.perf_counter()
    for variant in CFG.variants:
        are[variant] = {}
        for budget in CFG.budgets:
            spec = CFG.spec(variant, budget)
            s = count(spec, dev, dev_chunks)
            est = ops.query(s, probes).cpu().numpy()
            if est.shape != true.shape or not np.isfinite(est).all():
                fail(f"paper sweep {variant} {budget}: answers not finite")
            are[variant][budget] = float(np.mean(np.abs(est - true) / true))
            if budget in PAPER_TWINS:
                host = count(spec, "cpu",
                             [torch.from_numpy(c.astype(np.int64))
                              for c in chunks])
                apart[f"{variant}/{budget}"] = cells_apart(
                    s.table, host.table, spec,
                    f"paper sweep {variant} {budget}")
    seconds = time.perf_counter() - t0
    log(f"paper sweep: {len(events)} events ({len(uniq)} distinct) into "
        f"{len(CFG.variants) * len(CFG.budgets)} sketches; cells apart "
        f"card / CPU {apart}; {seconds:.1f} s")
    log("paper sweep ARE (Fig. 1), budget kB: "
        + ", ".join(f"{b // 1024}" for b in CFG.budgets))
    for variant, row in are.items():
        log(f"  {variant:10s} " + " ".join(f"{row[b]:.6f}"
                                           for b in CFG.budgets))
    small = CFG.budgets[0]
    if not are["CMLS16-CU"][small] < are["CMS-CU"][small]:
        fail(f"paper sweep: CMLS16 ARE {are['CMLS16-CU'][small]} not below "
             f"CMS-CU's {are['CMS-CU'][small]} at {small} B")
    return {"are": are, "cells_apart": apart, "events": int(len(events)),
            "distinct": int(len(uniq)), "seconds": seconds}


def close_ranking(a_ids, b_ids, score) -> bool:
    """Rank for rank the same pick, or picks whose scores (under `score`,
    id -> float) lie within 8 ulp: equal up to ulp-level ties."""
    return len(a_ids) == len(b_ids) and all(
        x == y or abs(score(x) - score(y)) <= ULP8 * abs(score(y))
        for x, y in zip(a_ids, b_ids))


def examples_check(dev) -> dict:
    """(d): the three examples at their default sizes through main(), on
    the card and on the CPU: equal numbers (the quickstart's ARE and
    estimates and trending_items' rankings exactly; streaming_pmi's RMSE
    within 1e-5 and its ranking up to ulp-level ties, since its
    estimators' log is torch's, which may round an ulp apart across
    devices).  The card run's printed lines go to the log."""
    import contextlib
    import io
    import quickstart_torch
    import streaming_pmi_torch
    import trending_items_torch
    res = {}
    for mod in (quickstart_torch, streaming_pmi_torch, trending_items_torch):
        name = mod.__name__
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            card = mod.main([])
        t_card = time.perf_counter() - t0
        with contextlib.redirect_stdout(io.StringIO()):
            host = mod.main(["--device", "cpu"])
        for line in out.getvalue().splitlines():
            log(f"  {name}: {line}")
        if mod is quickstart_torch:
            ok = (card["kernel_estimates"] == host["kernel_estimates"]
                  and card["are"] == host["are"])
            res[name] = {"are": card["are"],
                         "kernel_estimates": card["kernel_estimates"]}
        elif mod is streaming_pmi_torch:
            pmi = dict(zip(host["pairs"], host["pmi_est"].tolist()))
            ok = (abs(card["rmse"] - host["rmse"]) <= 1e-5
                  and card["bigrams"] == host["bigrams"]
                  and close_ranking(card["top10"], host["top10"],
                                    pmi.__getitem__))
            res[name] = {"rmse": card["rmse"], "bigrams": card["bigrams"],
                         "top10": card["top10"]}
        else:
            ok = card["hits"] == host["hits"] and card["board_hits"] == \
                host["board_hits"]
            ok &= all(np.array_equal(card["scores"][k].view(np.int32),
                                     v.view(np.int32))
                      for k, v in host["scores"].items())
            ok &= card["ranked"] == host["ranked"]
            ok &= card["boards"] == host["boards"]
            for board, est in host["board_estimates"].items():
                ok &= np.array_equal(
                    np.asarray(card["board_estimates"][board], np.float32)
                    .view(np.int32), np.asarray(est, np.float32)
                    .view(np.int32))
            res[name] = {"hits": card["hits"],
                         "board_hits": card["board_hits"],
                         "boards": card["boards"]}
        if not ok:
            fail(f"example {name}: the card's numbers differ from the CPU's")
        res[name]["card_seconds"] = t_card
    log(f"examples on the card equal the CPU: {res}")
    return res


def sharded_check(dev, tmp: str) -> dict:
    """(e): every function of core/sharded.py on a one-rank NCCL group
    (a FileStore in a temporary directory), each equal to its
    single-device composition: the merges are identities, the lazy and
    routed updates are update_batched / window_update of the dispatched
    keys (the jitted float graph, `eager=False`, as under shard_map), the
    routed reads equal ops.query / window_query (kernel 7), capacity
    overflow answers -1.0, routed_topk and routed_admit equal
    the local tracker's reselect and admit_tracked, merged_metrics is the
    identity."""
    import torch.distributed as dist
    from repro_torch.core import admission, sharded, topk
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import CMLS16, signed_view, to_i64
    from repro_torch.kernels import ops
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import mesh
    from repro_torch.stream import WindowSpec
    from repro_torch.stream import window as wnd

    def same(a, b, what):
        if not torch.equal(signed_view(a), signed_view(b)):
            fail(f"sharded W=1 {what}: differs from its composition")

    t0 = time.perf_counter()
    mesh.init_group(1, 0, backend="nccl", init_file=f"{tmp}/store")
    try:
        rng = np.random.default_rng(SEED + 33)
        spec = sk.SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16,
                                         packed=True)
        keys = torch.from_numpy(zipf_keys(rng, ALG_KEYS).astype(np.int64)
                                ).to(dev)
        valid = lambda flat: (to_i64(flat) != sharded.SENTINEL).to(
            torch.float32)
        local = sk.update_batched(sk.init(spec, device=dev), keys, [33, 0])
        same(sharded.pmax_merge(local).table, local.table, "pmax_merge")
        same(sharded.lazy_update(local, keys, [33, 1], 1, 2).table,
             sk.update_batched(local, keys, [33, 1], eager=False).table,
             "lazy_update")
        wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
        win = wnd.window_init(wspec, epoch=0, device=dev)
        win = wnd.window_update(win, keys, [33, 2])
        same(sharded.pmax_merge_window(win).tables, win.tables,
             "pmax_merge_window")
        same(sharded.lazy_update_window(win, keys, [33, 3], 1, 2).tables,
             wnd.window_update(win, keys, [33, 3], eager=False).tables,
             "lazy_update_window")
        stack = torch.stack([signed_view(local.table)] * 3).view(
            local.table.dtype)
        same(sharded.pmax_merge_window_stack(stack, spec), stack,
             "pmax_merge_window_stack")
        hot, full = sharded.pmax_merge_tier_stack(
            stack[:1].clone(), [2], stack.clone(), spec)
        same(hot, stack[:1], "pmax_merge_tier_stack")
        same(full, stack, "pmax_merge_tier_stack")
        buf, _, _ = sharded._dispatch_layout(keys, 1, ROUTE_CAP)
        flat = buf.reshape(-1)
        routed = sharded.routed_update(sk.init(spec, device=dev), keys,
                                       [33, 4], ROUTE_CAP)
        same(routed.table, sk.update_batched(
            sk.init(spec, device=dev), flat, [33, 4],
            weights=valid(flat), eager=False).table, "routed_update")
        probes = keys[:PROBES]
        ksk.reset_kernel_launches()
        got = sharded.routed_query(routed, probes, ROUTE_CAP)
        same(got, ops.query(routed, probes, engine="plain"), "routed_query")
        small = sharded.routed_query(routed, probes, PROBES // 2)
        if not (bool((small[PROBES // 2:] == -1.0).all())
                and torch.equal(small[:PROBES // 2], got[:PROBES // 2])):
            fail("sharded W=1 routed_query: overflow does not answer -1.0")
        rwin = wnd.window_init(wspec, epoch=0, device=dev)
        rwin = sharded.routed_window_update(rwin, keys, [33, 5], ROUTE_CAP,
                                            epoch=2)
        want = wnd.window_update(wnd.window_advance_steps(
            wnd.window_init(wspec, epoch=0, device=dev), 2), flat, [33, 5],
            weights=valid(flat), eager=False)
        same(rwin.tables, want.tables, "routed_window_update")
        if (rwin.cursor, rwin.epoch) != (2, 2):
            fail(f"sharded W=1 routed_window_update: cursor {rwin.cursor}")
        before = ksk.kernel_launches()["window_query"]
        got = sharded.routed_window_query(rwin, probes, ROUTE_CAP,
                                          gamma=0.5)
        torch.cuda.synchronize()
        if ksk.kernel_launches()["window_query"] != before + 1:
            fail("sharded W=1 routed_window_query: kernel 7 not launched")
        same(got, wnd.window_query(rwin, probes, gamma=0.5, engine="plain"),
             "routed_window_query")
        launches = ksk.kernel_launches()
        tr = topk.refresh(topk.init(TOPK_K, device=dev), routed, keys)
        top = sharded.routed_topk(tr, k=16)
        want = topk.reselect(tr.keys[None], tr.filled[None],
                             tr.estimates[None], 16)
        same(top.keys, want.keys[0], "routed_topk")
        same(top.estimates, want.estimates[0], "routed_topk")
        aspec = admission.AdmissionSpec(threshold=8.0)
        rows, mask = sharded.routed_admit(tr, keys[:4096], aspec)
        w_rows, w_mask = admission.admit_tracked(tr.keys, tr.estimates,
                                                 tr.filled, keys[:4096],
                                                 aspec)
        same(rows, w_rows, "routed_admit")
        same(mask, w_mask, "routed_admit")
        vals = torch.arange(7, dtype=torch.float32, device=dev)
        for mode in ("sum", "max"):
            same(sharded.merged_metrics(vals, mode=mode), vals,
                 f"merged_metrics {mode}")
    finally:
        dist.destroy_process_group()
    res = {"seconds": time.perf_counter() - t0,
           "routed_read_launches": {k: v for k, v in launches.items() if v},
           "overflow_answers": int((small == -1.0).sum())}
    log(f"sharded at world size 1 on NCCL: every function equals its "
        f"single-device composition; {res}")
    return res


def paper_phase(dev) -> tuple:
    """Phase 13: the repair at full width, topk.refresh, the paper's
    sweep, the three examples and the sharded functions at world size 1,
    (a)-(e).  Returns (kernel launches, the numbers it reports)."""
    import tempfile
    from repro_torch.kernels import sketch as ksk
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    res = {"repair": repair_check(dev), "topk": topk_check(dev),
           "paper_sweep": paper_sweep(dev), "examples": examples_check(dev)}
    torch.cuda.synchronize()
    launches = dict(ksk.kernel_launches())
    with tempfile.TemporaryDirectory() as tmp:
        res["sharded"] = sharded_check(dev, tmp)
    for k, v in res["sharded"]["routed_read_launches"].items():
        launches[k] += v
    res["seconds"] = time.perf_counter() - t0
    log(f"paper phase: {res['seconds']:.1f} s; launches {launches}")
    return launches, res

# ---- phase 18 of slice 15: the card against the CPU, bit for bit ------------

CPU_TENANTS = 4   # tenants of each service on the card and on the CPU
CPU_EPOCHS = 2


def bits(a) -> np.ndarray:
    """An array as the integers of its bits where it is float32, so a
    comparison tells -0.0 from 0.0 and compares NaNs."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def trees_apart(a, b) -> dict:
    """{leaf: entries apart} of two services' checkpoint trees."""
    from repro_torch.convert import service_to_numpy
    _, ta = service_to_numpy(a)
    _, tb = service_to_numpy(b)
    apart = {}
    for kind in ("planes", "windows"):
        for i, (la, lb) in enumerate(zip(ta[kind], tb[kind])):
            for key, va in la.items():
                pairs = (va.items() if isinstance(va, dict)
                         else [(key, va)])
                for sub, x in pairs:
                    y = lb[key][sub] if isinstance(va, dict) else lb[key]
                    n = int(np.sum(bits(x) != bits(y)))
                    if n:
                        apart[f"{kind}[{i}]/{key}/{sub}"] = n
    return apart


def card_cpu_phase(dev) -> tuple:
    """Phase 18: the tracked and the windowed service (CMLS16 at 4 MiB a
    tenant, the emb_ids admission policy on every tenant) driven on the
    card and on the CPU with one seed and one stream: CPU_TENANTS tenants
    each, CPU_EPOCHS epochs of MICRO microbatches of BATCH keys a tenant
    (the windowed ones at rotating event times).  Then query_all, the
    windowed reads (full window, n_buckets=3, max, gamma=0.9), topk and
    admit of every tenant.  Every leaf (tables, rings, trackers), every
    estimate and every admit mask must be equal bit for bit: the kernels
    on the card and the plain versions on the CPU compute the reference's
    float32 graph.  Returns (kernel launches of the card's run, the
    numbers it reports)."""
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import CMLS16
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve_counts as sc
    spec = sk.SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16)
    tnames = [f"tenant_{t:02d}" for t in range(CPU_TENANTS)]
    wnames = sc.trending_names(CPU_TENANTS)
    rng = np.random.default_rng(SEED + 18)
    stream, ts = [], 0.0
    for _ in range(CPU_EPOCHS):
        many, _ = sc.make_epoch(rng, CPU_TENANTS, MICRO, BATCH)
        pairs, ts = sc.make_trending(rng, CPU_TENANTS, MICRO, BATCH, ts)
        stream.append((many, pairs))
    probes = np.arange(PROBES, dtype=np.uint32)
    ids = {n: ((rng.zipf(1.3, BATCH) % 10_000)
               + t * 1_000_000).astype(np.uint32)
           for names in (tnames, wnames) for t, n in enumerate(names)}
    reads = {"full": {}, "n_buckets=3": {"n_buckets": 3},
             "max": {"mode": "max"}, "gamma=0.9": {"gamma": 0.9}}

    def drive(device):
        t0 = time.perf_counter()
        tracked = sc.build_service(spec, CPU_TENANTS, RING, SEED, TRACK_TOP,
                                   device=device, admission=sc.EMB_IDS)
        windowed = sc.build_service(spec, 0, RING, SEED, TRACK_TOP,
                                    device=device, trending=CPU_TENANTS,
                                    admission=sc.EMB_IDS)
        for many, pairs in stream:
            for events, (win_events, wts) in zip(many, pairs):
                tracked.enqueue_many(events)
                windowed.enqueue_many(win_events, ts=wts)
            tracked.flush()
            windowed.flush()
        out = {"query_all/tracked": tracked.query_all(probes),
               "query_all/windowed": windowed.query_all(probes)}
        for n in wnames:
            for what, kw in reads.items():
                out[f"query/{n}/{what}"] = windowed.query(n, probes, **kw)
        for svc, names in ((tracked, tnames), (windowed, wnames)):
            for n in names:
                out[f"topk/{n}"] = svc.topk(n)
                out[f"admit/{n}"] = svc.admit(n, ids[n])
        out["admit/trending_00/gamma=0.5"] = windowed.admit(
            wnames[0], ids[wnames[0]], gamma=0.5)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return tracked, windowed, out, time.perf_counter() - t0

    def flat(out) -> dict:
        res = {}
        for k, v in out.items():
            vs = v.items() if isinstance(v, dict) else enumerate(
                v if isinstance(v, tuple) else (v,))
            for sub, x in vs:
                if torch.is_tensor(x):
                    x = x.cpu().numpy()
                res[f"{k}/{sub}"] = np.asarray(x)
        return res

    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    card = drive(dev)
    launches = dict(ksk.kernel_launches())
    host = drive(torch.device("cpu"))
    apart = {**trees_apart(card[0], host[0]), **trees_apart(card[1], host[1])}
    got, want = flat(card[2]), flat(host[2])
    if list(got) != list(want):
        fail(f"card / CPU: different reads {sorted(set(got) ^ set(want))}")
    for k in got:
        n = int(np.sum(bits(got[k]) != bits(want[k])))
        if n or got[k].shape != want[k].shape:
            apart[k] = n
    cells = sum(int(np.asarray(v).size) for v in got.values())
    if apart:
        fail(f"card / CPU: entries apart {apart}")
    admitted = float(np.mean([float(v.mean()) for k, v in got.items()
                              if k.startswith("admit/") and k.endswith("/1")]))
    res = {"tenants": CPU_TENANTS, "epochs": CPU_EPOCHS,
           "events_tracked": int(card[0].stats["events"]),
           "events_windowed": int(card[1].stats["events"]),
           "read_entries_compared": cells, "entries_apart": 0,
           "admitted_share": admitted, "card_s": card[3], "cpu_s": host[3]}
    log(f"card against CPU: tracked and windowed services, {CPU_TENANTS} "
        f"tenants each, {CPU_EPOCHS} epochs: every leaf, {cells} read "
        f"entries (query_all, windowed full / n_buckets=3 / max / gamma "
        f"reads, topk, admit rows and masks) equal bit for bit; {res}; "
        f"launches {launches}")
    return launches, res


# ---- phase 14 of slice 11: the sketch-gated recommender path ----------------

REC_STEPS = 12             # train_batch steps counted, then trained
REC_BATCH = 65_536         # RECSYS_SHAPES["train_batch"]
SERVE_CELLS = (("serve_p99", 512), ("serve_bulk", 262_144))
SERVE_CALLS = 50
N_CANDIDATES = 1_000_000   # RECSYS_SHAPES["retrieval_cand"]
CAND_SLICE = 4_096         # candidates held card against CPU
TT_BATCH = 8_192           # two-tower train batch, cut from 65,536
TT_STEPS = 5
TWIN_BATCH = 512           # the card-against-CPU twins' batch
TWIN_STEPS = 3
TWIN_ROWS = 4_096          # twin tables: 4,096 private + 1,024 fallback
PEAK_LIMIT = 60 * 2**30    # full-width DLRM training's device memory
# card against CPU, normwise relative (max |card - cpu| / max |cpu|):
# float32 sums in another order on each side; measured at most 2.8e-6
# for a forward pass, 3.0e-5 for the parameters after TWIN_STEPS steps
# and 1.2e-8 for the example's BCE (NVIDIA H100 80GB HBM3, 700 W)
FWD_TOL = 2e-5             # forward passes and losses
STEP_TOL = 2e-4            # parameters after TWIN_STEPS train steps
BCE_TOL = 1e-6             # the example's final BCE (absolute)


def rel_err(card, host) -> float:
    """Normwise relative error max |card - host| / max |host|."""
    card = card.detach().cpu().double()
    host = host.detach().cpu().double()
    return float((card - host).abs().max()
                 / host.abs().max().clamp_min(1e-30))


def tree_rel_err(card: dict, host: dict) -> float:
    from repro_torch.models.params import flatten
    h = flatten(host)
    return max(rel_err(v, h[k]) for k, v in flatten(card).items())


def upload_ids(a: np.ndarray, dev) -> torch.Tensor:
    """Non-negative int32 ids as a flat torch.uint32 tensor on `dev`."""
    from repro_torch.core.counters import from_numpy
    return from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint32),
                      dev)


def to_dev(b: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in b.items()}


def admission_stream(dev, aspec):
    """(a): REC_STEPS `dlrm_batch`es of the train_batch shape over the
    Criteo cardinalities (26 fields, 1,703,936 ids a step), generated by
    the port's Prefetcher, counted in one 4 MiB CMLS16 sketch through
    `observe_and_admit` with engine "kernel" and, beside it, "xla": the
    sketch tables, rows and masks must be equal at every step.  Returns
    (the steps' device batches on the admitted rows, the sketch, the
    numbers it reports)."""
    from repro_torch.core import CMLS16, SketchSpec, prng
    from repro_torch.core import admission as adm
    from repro_torch.core import sketch as sk
    from repro_torch.core.counters import signed_view
    from repro_torch.data import pipeline, recsys_stream
    from repro_torch.models.recsys import criteo_tables
    spec = SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16)
    kern, xla = sk.init(spec, dev), sk.init(spec, dev)
    src = pipeline.BatchSource(lambda s, sh, n: recsys_stream.dlrm_batch(
        s, sh, n, global_batch=REC_BATCH, table_sizes=criteo_tables(),
        seed=SEED))
    pf = pipeline.Prefetcher(src, 0, 1, depth=2)
    key = np.asarray([SEED, 14], np.uint32)
    stream, ms, admitted, distinct = [], [], [], []
    try:
        for step, b in pf:
            if step >= REC_STEPS:
                break
            key, k = prng.split(key, 2)
            ids = upload_ids(b["sparse"], dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kern, rows, mask = adm.observe_and_admit(kern, ids, k, aspec,
                                                     engine="kernel")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            xla, rx, mx = adm.observe_and_admit(xla, ids, k, aspec,
                                                engine="xla")
            if not (torch.equal(signed_view(kern.table),
                                signed_view(xla.table))
                    and torch.equal(rows, rx) and torch.equal(mask, mx)):
                fail(f"recsys (a) step {step}: observe_and_admit 'kernel' "
                     f"differs from 'xla' ({int((mask != mx).sum())} "
                     f"decisions)")
            admitted.append(int(mask.sum()))
            distinct.append(int(np.unique(b["sparse"]).size))
            stream.append({"dense": torch.from_numpy(b["dense"]).to(dev),
                           "sparse": rows.reshape(REC_BATCH, -1),
                           "label": torch.from_numpy(b["label"]).to(dev)})
    finally:
        pf.close()
    res = {"ids_a_step": REC_BATCH * 26, "distinct_a_step": distinct,
           "admitted_a_step": admitted,
           "observe_and_admit_ms": summary(ms)}
    log(f"recsys (a): {REC_STEPS} steps of {REC_BATCH} x 26 ids, "
        f"observe_and_admit 'kernel' == 'xla' at every step (tables, rows, "
        f"masks); admitted {admitted}, distinct {distinct}; kernel engine "
        f"ms {res['observe_and_admit_ms']}")
    return stream, kern, res


def dlrm_train(dev, cfg, stream):
    """(b): dlrm-mlperf's widths on 26 admission-gated tables, trained
    through `make_train_step` on (a)'s steps: finite losses, every row no
    admitted or fallback id looked up bit-identical to its start, the
    peak device memory below PEAK_LIMIT.  Returns (params, report, a
    drive of one more train step on the last batch, for phase 12)."""
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    from repro_torch.train import loop, optimizer
    specs = rs.dlrm_specs(cfg)
    res = {"peak_before_bytes": torch.cuda.max_memory_allocated()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mp.init_tree(specs, SEED, dev)
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    start = {k: v.clone() for k, v in params["tables"].items()}
    touched = {k: torch.zeros(v.shape[0], dtype=torch.bool, device=dev)
               for k, v in params["tables"].items()}
    init, step = loop.make_train_step(
        lambda p, b, r: rs.dlrm_loss(p, b, cfg),
        optimizer.OptimizerConfig(peak_lr=2e-3, warmup_steps=2,
                                  decay_steps=REC_STEPS))
    state = init(params, np.asarray([SEED, 2], np.uint32))
    losses, ms = [], []
    for b in stream:
        for i in range(cfg.n_sparse):
            touched[f"t{i}"][b["sparse"][:, i].long()] = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        fail(f"recsys (b): non-finite DLRM loss {losses}")
    peak = torch.cuda.max_memory_allocated()
    if peak >= PEAK_LIMIT:
        fail(f"recsys (b): peak device memory {peak / 2**30:.2f} GiB")
    moved = bad = 0
    for k, t in state.params["tables"].items():
        diff = (t.view(torch.int32) != start[k].view(torch.int32)).any(dim=1)
        bad += int((diff & ~touched[k]).sum())
        moved += int(diff.sum())
    if bad:
        fail(f"recsys (b): {bad} table rows no id touched have changed")
    res.update({
        "table_bytes": mp.param_bytes(specs["tables"]),
        "dense_params": mp.param_count({k: v for k, v in specs.items()
                                        if k != "tables"}),
        "losses": losses, "train_step_ms": summary(ms),
        "peak_bytes": peak, "rows_touched": sum(
            int(v.sum()) for v in touched.values()), "rows_moved": moved})
    log(f"recsys (b): DLRM {res['dense_params']} dense parameters, tables "
        f"{res['table_bytes']} B, init {res['init_s']:.2f} s; losses "
        f"{[round(x, 5) for x in losses]}; train step ms "
        f"{res['train_step_ms']}; peak {peak / 2**30:.2f} GiB; rows touched "
        f"{res['rows_touched']}, moved {moved}, untouched rows bit-identical")
    last = stream[-1]

    def drive():
        nonlocal state
        state, _ = step(state, last)
    return state.params, res, drive


def twin_runs(dev, specs, loss_fn, fwd, batches, key):
    """(forward, losses, params) of TWIN_STEPS train steps from the same
    weights and batches on the card and on the CPU."""
    from repro_torch import convert
    from repro_torch.models import params as mp
    from repro_torch.train import loop, optimizer
    p0 = convert.params_to_numpy(mp.init_tree(specs, SEED, "cpu"))
    runs = []
    for d in (dev, torch.device("cpu")):
        params = convert.params_from_numpy(p0, d)
        tb = [to_dev(b, d) for b in batches]
        forward = fwd(params, tb[0])
        init, step = loop.make_train_step(
            lambda p, b, r: loss_fn(p, b),
            optimizer.OptimizerConfig(peak_lr=2e-3, warmup_steps=2,
                                      decay_steps=TWIN_STEPS))
        state = init(params, key)
        losses = []
        for b in tb:
            state, m = step(state, b)
            losses.append(m["loss"])
        runs.append((forward, torch.stack(losses), state.params))
    (fc, lc, pc), (fh, lh, ph) = runs
    res = {"forward": rel_err(fc, fh), "loss": rel_err(lc, lh),
           "params": tree_rel_err(pc, ph),
           "losses": [float(x) for x in lc]}
    if not (bool(torch.isfinite(fc).all()) and res["forward"] <= FWD_TOL
            and res["loss"] <= FWD_TOL and res["params"] <= STEP_TOL):
        fail(f"recsys card against CPU: {res}")
    return res


def dlrm_twin(dev, cfg, aspec) -> dict:
    """(b), card against CPU: full MLP widths at batch TWIN_BATCH, the
    tables cut to TWIN_ROWS + 1,024 rows; the admission decided on the
    card (kernels) and on the CPU (plain engine), rows equal."""
    import dataclasses
    from repro_torch.core import CMLS16, SketchSpec, prng
    from repro_torch.core import admission as adm
    from repro_torch.core import sketch as sk
    from repro_torch.data import recsys_stream
    from repro_torch.models import recsys as rs
    tspec = adm.AdmissionSpec(threshold=aspec.threshold,
                              n_fallback=aspec.n_fallback,
                              table_rows=TWIN_ROWS)
    tcfg = dataclasses.replace(
        cfg, table_sizes=(tspec.n_fallback + tspec.table_rows,) * 26)
    spec = SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16)
    card, host = sk.init(spec, dev), sk.init(spec, "cpu")
    key = np.asarray([SEED, 24], np.uint32)
    batches = []
    for s in range(TWIN_STEPS):
        b = recsys_stream.dlrm_batch(s, 0, 1, global_batch=TWIN_BATCH,
                                     table_sizes=rs.criteo_tables(),
                                     seed=SEED)
        key, k = prng.split(key, 2)
        card, rows, _ = adm.observe_and_admit(card, upload_ids(b["sparse"],
                                                               dev), k, tspec)
        host, rh, _ = adm.observe_and_admit(host, upload_ids(b["sparse"],
                                                             "cpu"), k, tspec)
        if not torch.equal(rows.cpu(), rh):
            fail("recsys (b) twin: admitted rows differ card / CPU")
        batches.append(dict(b, sparse=rh.reshape(TWIN_BATCH, -1).numpy()))
    res = twin_runs(dev, rs.dlrm_specs(tcfg),
                    lambda p, b: rs.dlrm_loss(p, b, tcfg),
                    lambda p, b: rs.dlrm_apply(p, b, tcfg), batches,
                    np.asarray([SEED, 2], np.uint32))
    log(f"recsys (b) card against CPU (batch {TWIN_BATCH}, "
        f"{TWIN_ROWS + tspec.n_fallback}-row tables, {TWIN_STEPS} steps): "
        f"logits {res['forward']:.3e}, losses {res['loss']:.3e}, params "
        f"{res['params']:.3e} (normwise relative; tolerance {FWD_TOL} / "
        f"{STEP_TOL})")
    return res


def compact(table: torch.Tensor, idx: torch.Tensor):
    """(the rows `idx` reads, as a CPU table; idx into it, on the CPU)."""
    uniq, inv = torch.unique(idx.long(), return_inverse=True)
    return table[uniq].cpu(), inv.cpu()


def serving_check(dev, cfg, params, sketch, aspec):
    """(c): `admit` then `dlrm_apply` at serve_p99 and serve_bulk (p50 /
    p95 over SERVE_CALLS calls, host clock to synchronize), then
    `dlrm_score_candidates` over N_CANDIDATES; outputs finite, a
    512-row and a CAND_SLICE-candidate slice held against the CPU (the
    rows they read gathered into CPU tables).  Returns (report, {cell:
    one call's drive}, for phase 12)."""
    import dataclasses
    from repro_torch.core import admission as adm
    from repro_torch.data import recsys_stream
    from repro_torch.models import recsys as rs
    res, drives = {}, {}
    dense_cpu = {k: {n: v.cpu() for n, v in params[k].items()}
                 for k in ("bot", "top")}
    keep = None
    with torch.no_grad():
        for cell, n in SERVE_CELLS:
            b = recsys_stream.dlrm_batch(10_000 + n, 0, 1, global_batch=n,
                                         table_sizes=rs.criteo_tables(),
                                         seed=SEED)
            ids, dense = upload_ids(b["sparse"], dev), torch.from_numpy(
                b["dense"]).to(dev)

            def call(ids=ids, dense=dense, n=n):
                rows, _ = adm.admit(sketch, ids, aspec)
                sparse = rows.reshape(n, -1)
                return sparse, rs.dlrm_apply(
                    params, {"dense": dense, "sparse": sparse}, cfg)

            drives[cell] = torch.no_grad()(call)
            call()
            ms = []
            for _ in range(SERVE_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sparse, out = call()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            if out.shape != (n,) or not bool(torch.isfinite(out).all()):
                fail(f"recsys (c) {cell}: logits not finite or misshapen")
            res[cell] = {"batch": n, "p50_ms": float(np.percentile(ms, 50)),
                         "p95_ms": float(np.percentile(ms, 95)),
                         "rows_a_s": n / (np.median(ms) / 1e3)}
            if keep is None:
                keep = (sparse, dense, out)
        sparse, dense, out = keep
        tables = {}
        sparse_cpu = torch.empty(sparse.shape, dtype=torch.int64)
        for i in range(cfg.n_sparse):
            tables[f"t{i}"], sparse_cpu[:, i] = compact(
                params["tables"][f"t{i}"], sparse[:, i])
        host = rs.dlrm_apply({"tables": tables, **dense_cpu},
                             {"dense": dense.cpu(), "sparse": sparse_cpu},
                             cfg)
        res["serve_p99_card_vs_cpu"] = rel_err(out, host)

        rng = np.random.default_rng(SEED + 14)
        cand = torch.from_numpy(rng.integers(
            0, rs.MAX_IND_RANGE, N_CANDIDATES)).to(dev)
        ctx = {"dense": dense[:1], "sparse": sparse[:1]}
        rs.dlrm_score_candidates(params, ctx, cand, cfg)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = rs.dlrm_score_candidates(params, ctx, cand, cfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if scores.shape != (N_CANDIDATES,) or not bool(
                torch.isfinite(scores).all()):
            fail("recsys (c) retrieval_cand: scores not finite or misshapen")
        res["retrieval_cand"] = {"candidates": N_CANDIDATES,
                                 "ms": summary(ms)}
        cand_rows = cand[:CAND_SLICE] % cfg.table_sizes[0]
        tables = {}
        ctx_cpu = torch.zeros((1, cfg.n_sparse), dtype=torch.int64)
        for i in range(cfg.n_sparse):
            idx = cand_rows if i == 0 else sparse[:1, i]
            tables[f"t{i}"], inv = compact(params["tables"][f"t{i}"], idx)
            if i == 0:
                cand_cpu = inv
        ccfg = dataclasses.replace(cfg, table_sizes=(
            tables["t0"].shape[0],) + cfg.table_sizes[1:])
        host = rs.dlrm_score_candidates(
            {"tables": tables, **dense_cpu},
            {"dense": dense[:1].cpu(), "sparse": ctx_cpu}, cand_cpu, ccfg)
        res["retrieval_card_vs_cpu"] = rel_err(scores[:CAND_SLICE], host)
    if max(res["serve_p99_card_vs_cpu"],
           res["retrieval_card_vs_cpu"]) > FWD_TOL:
        fail(f"recsys (c): card against CPU {res}")
    log(f"recsys (c): admit + dlrm_apply {res['serve_p99']} / "
        f"{res['serve_bulk']}; dlrm_score_candidates over {N_CANDIDATES} "
        f"ms {res['retrieval_cand']['ms']}; card against CPU: 512 rows "
        f"{res['serve_p99_card_vs_cpu']:.3e}, {CAND_SLICE} candidates "
        f"{res['retrieval_card_vs_cpu']:.3e}")
    return res, drives


def twotower_check(dev):
    """(d): two-tower at its full widths (5,000,192 + 1,000,448 rows of
    256 floats, towers 1024-512-256): TT_STEPS train steps at TT_BATCH
    with `item_logq` = log(estimate / events counted) of a CMLS16 sketch
    counting the item_id stream (kernels 5 and 1), then
    `twotower_score_candidates` over N_CANDIDATES; a slice of the scores
    and a small model's TWIN_STEPS steps held against the CPU.  Returns
    (report, a drive of one more train step, for phase 12)."""
    import dataclasses
    from repro_torch.configs import two_tower
    from repro_torch.core import CMLS16, SketchSpec, prng
    from repro_torch.core import sketch as sk
    from repro_torch.data import recsys_stream
    from repro_torch.kernels import ops
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    from repro_torch.train import loop, optimizer
    c = two_tower.CFG
    specs = rs.twotower_specs(c)
    res = {"table_bytes": mp.param_bytes({k: specs[k] for k in (
        "user_table", "item_table")})}
    torch.cuda.reset_peak_memory_stats()
    params = mp.init_tree(specs, SEED, dev)
    sketch = sk.init(SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16),
                     dev)
    init, step = loop.make_train_step(
        lambda p, b, r: rs.twotower_loss(p, b, c),
        optimizer.OptimizerConfig(peak_lr=2e-3, warmup_steps=2,
                                  decay_steps=TT_STEPS))
    state = init(params, np.asarray([SEED, 3], np.uint32))
    key = np.asarray([SEED, 15], np.uint32)
    items, losses, ms = [], [], []
    for s in range(TT_STEPS):
        b = recsys_stream.twotower_batch(s, 0, 1, global_batch=TT_BATCH,
                                         n_users=c.n_users,
                                         n_items=c.n_items, seed=SEED)
        items.append(b["item_id"])
        ids = upload_ids(b["item_id"], dev)
        key, k = prng.split(key, 2)
        sketch = ops.update_chunked(sketch, ids, k)
        logq = torch.log(ops.query(sketch, ids) / (TT_BATCH * (s + 1)))
        batch = dict(to_dev({k_: b[k_] for k_ in ("user_feats",
                                                  "item_feats")}, dev),
                     item_logq=logq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        fail(f"recsys (d): non-finite two-tower loss {losses}")
    # the logQ the sketch supplied tracks the exact item frequencies
    all_items = np.concatenate(items)
    uniq, counts = np.unique(all_items, return_counts=True)
    sel = counts >= 20
    est = ops.query(sketch, upload_ids(uniq[sel], dev)).cpu().numpy()
    res["logq_mean_abs_err"] = float(np.abs(
        np.log(est / all_items.size)
        - np.log(counts[sel] / all_items.size)).mean())
    if not res["logq_mean_abs_err"] < 0.15:
        fail(f"recsys (d): sketch logQ off by {res['logq_mean_abs_err']}")
    res.update({"losses": losses, "train_step_ms": summary(ms),
                "peak_bytes": torch.cuda.max_memory_allocated()})
    params = state.params
    rng = np.random.default_rng(SEED + 15)
    cand = torch.from_numpy(rng.integers(
        0, c.n_items, (N_CANDIDATES, c.n_item_feats)).astype(np.int32)
        ).to(dev)
    query = {"user_feats": batch["user_feats"][:1]}
    with torch.no_grad():
        rs.twotower_score_candidates(params, query, cand, c)
        sms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = rs.twotower_score_candidates(params, query, cand, c)
            torch.cuda.synchronize()
            sms.append((time.perf_counter() - t0) * 1e3)
        if scores.shape != (1, N_CANDIDATES) or not bool(
                torch.isfinite(scores).all()):
            fail("recsys (d): candidate scores not finite or misshapen")
        item_t, cand_cpu = compact(params["item_table"],
                                   cand[:CAND_SLICE].reshape(-1))
        user_t, user_cpu = compact(params["user_table"],
                                   query["user_feats"].reshape(-1))
        towers = {k: {n: v.cpu() for n, v in params[k].items()}
                  for k in ("user_tower", "item_tower")}
        host = rs.twotower_score_candidates(
            {"user_table": user_t, "item_table": item_t, **towers},
            {"user_feats": user_cpu.reshape(1, -1)},
            cand_cpu.reshape(CAND_SLICE, -1), c)
    res["retrieval_cand"] = {"candidates": N_CANDIDATES, "ms": summary(sms)}
    res["retrieval_card_vs_cpu"] = rel_err(scores[:, :CAND_SLICE], host)
    if res["retrieval_card_vs_cpu"] > FWD_TOL:
        fail(f"recsys (d): scores card against CPU {res}")
    del params, scores, cand

    def drive():
        nonlocal state
        state, _ = step(state, batch)

    small = dataclasses.replace(c, n_users=TWIN_ROWS, n_items=TWIN_ROWS)
    batches = []
    for s in range(TWIN_STEPS):
        b = recsys_stream.twotower_batch(s, 0, 1, global_batch=TWIN_BATCH,
                                         n_users=TWIN_ROWS,
                                         n_items=TWIN_ROWS, seed=SEED)
        b["item_logq"] = np.log((b["item_id"] % 97 + 1) / 1000.0).astype(
            np.float32)
        batches.append(b)
    res["twin"] = twin_runs(
        dev, rs.twotower_specs(small),
        lambda p, b: rs.twotower_loss(p, b, small),
        lambda p, b: torch.cat(rs.twotower_embed(p, b, small), dim=1),
        batches, np.asarray([SEED, 3], np.uint32))
    log(f"recsys (d): two-tower tables {res['table_bytes']} B; losses "
        f"{[round(x, 4) for x in losses]}; train step ms "
        f"{res['train_step_ms']}; peak {res['peak_bytes'] / 2**30:.2f} GiB; "
        f"sketch logQ mean abs err {res['logq_mean_abs_err']:.4f}; "
        f"twotower_score_candidates over {N_CANDIDATES} ms "
        f"{res['retrieval_cand']['ms']}; card against CPU: "
        f"{CAND_SLICE} candidates {res['retrieval_card_vs_cpu']:.3e}, "
        f"{TWIN_ROWS}-row twin {res['twin']}")
    return res, drive


def recsys_example_check() -> dict:
    """(e): `recsys_admission_torch.main` at its defaults on the card and
    with --device cpu from the same `params0`: the counts and table lines
    equal, the final BCEs within BCE_TOL."""
    import contextlib
    import io
    import recsys_admission_torch as ex
    from repro_torch import convert
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    p0 = convert.params_to_numpy(mp.init_tree(rs.dlrm_specs(ex.CFG), SEED,
                                              "cpu"))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        card = ex.main([], params0=p0)
    t_card = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):
        host = ex.main(["--device", "cpu"], params0=p0)
    for line in out.getvalue().splitlines():
        log(f"  recsys_admission_torch: {line}")
    diff = {p: abs(card["bce"][p] - host["bce"][p]) for p in ex.POLICIES}
    if not (card["counts"] == host["counts"]
            and card["table_line"] == host["table_line"]
            and max(diff.values()) <= BCE_TOL):
        fail(f"recsys (e): the example's card numbers differ from the "
             f"CPU's: {card['bce']} / {host['bce']}, {card['counts']} / "
             f"{host['counts']}")
    log(f"recsys (e): the example card == CPU (counts, table line), BCE "
        f"card {card['bce']} against CPU {host['bce']}")
    return {"bce": card["bce"], "bce_cpu": host["bce"], "bce_diff": diff,
            "counts": card["counts"], "card_seconds": t_card}


def recsys_phase(dev) -> tuple:
    """Phase 14: the sketch-gated recommender path at dlrm-mlperf's and
    two-tower's full widths, (a)-(e).  Returns (kernel launches, the
    numbers it reports, {name: drive} of one DLRM train step, one
    serve_p99 and one serve_bulk call and one two-tower train step for
    phase 12's profiles)."""
    import dataclasses
    import gc
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.core import admission as adm
    from repro_torch.kernels import sketch as ksk
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    aspec = adm.AdmissionSpec()
    cfg = dataclasses.replace(
        dlrm_mlperf.CFG,
        table_sizes=(aspec.n_fallback + aspec.table_rows,) * 26)
    res = {}
    res["live_before_bytes"] = torch.cuda.memory_allocated()
    stream, sketch, res["admission"] = admission_stream(dev, aspec)
    torch.cuda.synchronize()
    res["admission"]["launches"] = {k: v for k, v in
                                    ksk.kernel_launches().items() if v}
    log(f"recsys (a) launches: {res['admission']['launches']} (kernels 5 "
        f"and 1 once a step)")
    params, res["train"], train_drive = dlrm_train(dev, cfg, stream)
    res["serve"], drives = serving_check(dev, cfg, params, sketch, aspec)
    drives["dlrm_train_step"] = train_drive
    del params, stream
    gc.collect()
    torch.cuda.empty_cache()
    res["dlrm_twin"] = dlrm_twin(dev, cfg, aspec)
    res["two_tower"], drives["twotower_train_step"] = twotower_check(dev)
    gc.collect()
    torch.cuda.empty_cache()
    res["example"] = recsys_example_check()
    torch.cuda.synchronize()
    launches = dict(ksk.kernel_launches())
    if not (launches["fused_update"] and launches["fused_query"]):
        fail(f"recsys phase: kernels 5 and 1 not both launched {launches}")
    res["seconds"] = time.perf_counter() - t0
    log(f"recsys phase: {res['seconds']:.1f} s; launches {launches}")
    return launches, res, drives


# ---- phase 15 of slice 12: the LM and sequential-recommender scaffold -------

LM_STEPS = 5               # qwen2-0.5b train steps at train_4k's sequence
LM_BATCH = 4               # cut from train_4k's 256 (the peak, below)
LM_SEQ = 4_096             # LM_SHAPES["train_4k"]
LM_LR = 1e-3               # AdamW's peak, no warmup
LM_PEAK_LIMIT = 60 * 2**30  # qwen2-0.5b training's device memory
SERVE_BATCH = 8            # prefill 2,048 then SERVE_GEN decodes
SERVE_PROMPT = 2_048
SERVE_GEN = 64
LONG_BATCH = 2             # decode_32k's cache length, batch cut from 128
LONG_LEN = 32_768          # LM_SHAPES["decode_32k"]
LONG_CHUNK_Q = 2_048       # the prefill's query chunk (launch/cells.py:164)
LONG_PROMPT = LONG_LEN - LONG_CHUNK_Q
LONG_GEN = 16
# the other four LM configs at their published widths, depth cut to one
# pattern period (after deepseek's dense prefix)
OTHER_LMS = (("phi3-mini-3.8b", 2), ("gemma2-27b", 2),
             ("llama4-scout-17b-a16e", 4), ("deepseek-v2-lite-16b", 3))
OTHER_BATCH = 2
OTHER_PROMPT = 512
OTHER_GEN = 16
DECODE_TOL = 5e-2          # decode vs apply, bf16 (tests/test_models_smoke.py)
E2E_TRAIN = (30, 32, 1_024)  # launch.train's steps (cut from 300), batch, seq
SEQREC_STEPS = 3
# train_batch is 65,536: SASRec's sampled softmax holds (B, B + 512)
# float32 logits (17.3 GB at 65,536; 68.3 GiB peak alone), BERT4Rec's
# encoder (B, 2, 200, 200) float32 scores a block (21 GB at 65,536)
SEQREC_BATCH = {"sasrec": 32_768, "bert4rec": 8_192}
SEQREC_USERS = 512         # RECSYS_SHAPES["serve_p99"], k = 100
SEQREC_K = 100
TWIN_PROMPT = 12           # smoke twins: prefill 12, decode to 16
TWIN_LEN = 16
# card against CPU at the smoke configs, float32 with TF32 off, normwise
# relative: the CPU tests' tolerances (tests/test_torch_lm.py)
LM_FWD_TOL = 1e-5
LM_GRAD_TOL = 1e-4


def peak_report(what: str, res: dict, base: int) -> None:
    torch.cuda.synchronize()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["peak_above_live_bytes"] = res["peak_bytes"] - base
    log(f"{what}: peak {res['peak_bytes'] / 2**30:.2f} GiB "
        f"({res['peak_above_live_bytes'] / 2**30:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB live before)")


def fresh_peak() -> int:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def serve_and_check(dev, params, cfg, batch: int, prompt_len: int,
                    gen: int, seed: int, max_len: int | None = None,
                    check: bool = True) -> dict:
    """Prefill a (batch, prompt_len) prompt into a cache of `max_len`
    slots (prompt_len + gen by default), then `gen` greedy decodes,
    timed; with `check`, the prefill's and every decode's logits against
    one `apply` over the same tokens (DECODE_TOL, as
    tests/test_models_smoke.py holds them in bf16)."""
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf
    max_len = max_len or prompt_len + gen
    prompt = prng.randint((SEED, seed), (batch, prompt_len), 0,
                          cfg.vocab_size, device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tf.prefill(params, prompt, cfg, max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs, toks = [logits], [torch.argmax(logits, -1)[:, None]]
        pos = torch.full((), prompt_len, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for _ in range(gen):
            logits, cache = tf.decode_step(params, cache, toks[-1], pos, cfg)
            outs.append(logits)
            toks.append(torch.argmax(logits, -1)[:, None])
            pos = pos + 1
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        res = {"prefill_ms": prefill_ms,
               "decode_tokens_per_s": batch * gen / decode_s,
               "decode_step_ms": decode_s / gen * 1e3}
        got = torch.stack(outs[:gen + 1], dim=1)          # (B, gen+1, V)
        if not bool(torch.isfinite(got).all()):
            fail(f"lm serve {cfg.name}: non-finite logits")
        if check:
            seq = torch.cat([prompt] + toks[:gen], dim=1)  # (B, P + gen)
            full, _ = tf.apply(params, seq, cfg)
            want = full[:, prompt_len - 1:]
            err = (got - want).abs() - DECODE_TOL * (1 + want.abs())
            res["decode_vs_apply_max_abs"] = float((got - want).abs().max())
            if float(err.max()) > 0:
                fail(f"lm serve {cfg.name}: decode logits differ from apply "
                     f"by {res['decode_vs_apply_max_abs']}")
            del full, want
    return res


def qwen_full(dev) -> dict:
    """(a): qwen2-0.5b at its full config."""
    import dataclasses
    from repro_torch.configs import qwen2_05b
    from repro_torch.data import corpus, pipeline
    from repro_torch.models import params as mp
    from repro_torch.models import transformer as tf
    from repro_torch.train import loop, optimizer
    cfg = qwen2_05b.CFG
    res = {"params": mp.param_count(tf.param_specs(cfg))}
    base = fresh_peak()
    params = mp.init_tree(tf.param_specs(cfg), SEED, dev)
    tokens = corpus.generate(corpus.CorpusSpec(n_tokens=500_000))
    src = pipeline.token_batch_source(tokens, LM_BATCH, LM_SEQ, SEED)
    init, step = loop.make_train_step(
        lambda p, b, r: tf.loss_fn(p, b, cfg),
        optimizer.OptimizerConfig(peak_lr=LM_LR, warmup_steps=0,
                                  decay_steps=LM_STEPS))
    state = init(params, np.asarray([SEED, 15], np.uint32))
    losses, ms = [], []
    for s in range(LM_STEPS):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in src.batch(s, 0, 1).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"lm (a): qwen2-0.5b losses not finite and falling: {losses}")
    step_ms = float(np.median(ms[1:]))
    n_tok = LM_BATCH * LM_SEQ
    res["train"] = {"batch": LM_BATCH, "seq": LM_SEQ, "losses": losses,
                    "step_ms": ms, "step_ms_median": step_ms,
                    "tokens_per_s": n_tok / step_ms * 1e3,
                    "model_flops_per_step": tf.model_flops(cfg, n_tok,
                                                           LM_SEQ)}
    res["train"]["model_flops_per_s"] = (
        res["train"]["model_flops_per_step"] / step_ms * 1e3)
    peak_report("lm (a) train", res["train"], base)
    if res["train"]["peak_bytes"] >= LM_PEAK_LIMIT:
        fail(f"lm (a): training peak {res['train']['peak_bytes']} B")
    log(f"lm (a): qwen2-0.5b {res['params']} parameters, {LM_STEPS} steps "
        f"of {LM_BATCH} x {LM_SEQ}: losses {[round(x, 4) for x in losses]}, "
        f"step ms {[round(x, 1) for x in ms]} (median after the first "
        f"{step_ms:.1f}), {res['train']['tokens_per_s']:.0f} tokens/s, "
        f"{res['train']['model_flops_per_s'] / 1e12:.1f} model TFLOP/s")
    params = state.params
    del state, step, init
    base = fresh_peak()
    res["serve_2k"] = serve_and_check(dev, params, cfg, SERVE_BATCH,
                                      SERVE_PROMPT, SERVE_GEN, 151)
    peak_report("lm (a) serve 2k", res["serve_2k"], base)
    log(f"lm (a): prefill {SERVE_BATCH} x {SERVE_PROMPT} in "
        f"{res['serve_2k']['prefill_ms']:.1f} ms, {SERVE_GEN} decodes at "
        f"{res['serve_2k']['decode_tokens_per_s']:.0f} tokens/s "
        f"({res['serve_2k']['decode_step_ms']:.2f} ms a step); decode == "
        f"apply within {DECODE_TOL} (max |diff| "
        f"{res['serve_2k']['decode_vs_apply_max_abs']:.4f})")
    base = fresh_peak()
    res["decode_32k"] = serve_and_check(
        dev, params, dataclasses.replace(cfg, chunk_q=LONG_CHUNK_Q),
        LONG_BATCH, LONG_PROMPT, LONG_GEN, 152, max_len=LONG_LEN,
        check=False)
    peak_report("lm (a) decode 32k", res["decode_32k"], base)
    log(f"lm (a): prefill {LONG_BATCH} x {LONG_PROMPT} (chunk_q "
        f"{LONG_CHUNK_Q}) in {res['decode_32k']['prefill_ms']:.1f} ms, "
        f"{LONG_GEN} decodes on the {LONG_LEN}-slot cache at "
        f"{res['decode_32k']['decode_tokens_per_s']:.0f} tokens/s")
    return res


def other_lms(dev) -> dict:
    """(b): the four other LM configs at their published widths, depth cut
    to one pattern period; each freed before the next."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import params as mp
    from repro_torch.models import transformer as tf
    res = {}
    for i, (name, layers) in enumerate(OTHER_LMS):
        cfg = dataclasses.replace(registry.get(name).cfg, n_layers=layers)
        base = fresh_peak()
        t0 = time.perf_counter()
        params = mp.init_tree(tf.param_specs(cfg), SEED, dev)
        torch.cuda.synchronize()
        r = {"layers": layers, "params": mp.param_count(tf.param_specs(cfg)),
             "init_s": time.perf_counter() - t0}
        if cfg.moe is None:
            r.update(serve_and_check(dev, params, cfg, OTHER_BATCH,
                                     OTHER_PROMPT, OTHER_GEN, 160 + i))
        else:
            # timed as published; checked in float32 with no token
            # dropped: the capacity follows the token count, so a decode
            # (2 tokens) and `apply` (1,056) would drop different tokens,
            # and a bf16 rounding can flip a top-k routing decision
            # between the two (llama4-scout: 0.078 apart in bf16)
            r.update(serve_and_check(dev, params, cfg, OTHER_BATCH,
                                     OTHER_PROMPT, OTHER_GEN, 160 + i,
                                     check=False))
            nodrop = dataclasses.replace(
                cfg, dtype=torch.float32, moe=dataclasses.replace(
                    cfg.moe,
                    capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
            r["decode_vs_apply_max_abs"] = serve_and_check(
                dev, params, nodrop, OTHER_BATCH, OTHER_PROMPT, OTHER_GEN,
                160 + i)["decode_vs_apply_max_abs"]
        del params
        peak_report(f"lm (b) {name}", r, base)
        res[name] = r
        log(f"lm (b): {name} at {layers} layers ({r['params']} parameters): "
            f"prefill {OTHER_BATCH} x {OTHER_PROMPT} in "
            f"{r['prefill_ms']:.1f} ms, {OTHER_GEN} decodes at "
            f"{r['decode_tokens_per_s']:.0f} tokens/s, decode == apply "
            f"(max |diff| {r['decode_vs_apply_max_abs']:.4f})")
    return res


def lm_twin(dev, name: str) -> dict:
    """(c): one LM smoke config from the same float32 weights on the card
    and on the CPU: logits, loss, gradients, the prefill cache and four
    decode steps."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.models import params as mp
    from repro_torch.models import transformer as tf
    cfg = registry.get(name).smoke_cfg
    p0 = convert.params_to_numpy(mp.init_tree(tf.param_specs(cfg), SEED,
                                              "cpu"))
    toks = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (2, TWIN_LEN)).astype(np.int32)
    out = []
    for d in (dev, torch.device("cpu")):
        t = torch.from_numpy(toks).to(d)
        leaves = {k: v.requires_grad_() for k, v in mp.flatten(
            convert.params_from_numpy(p0, d)).items()}
        loss, _ = tf.loss_fn(mp.unflatten(leaves),
                             {"tokens": t, "targets": t.roll(-1, 1)}, cfg)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        params = mp.unflatten({k: v.detach() for k, v in leaves.items()})
        with torch.no_grad():
            logits, _ = tf.apply(params, t, cfg)
            _, cache = tf.prefill(params, t[:, :TWIN_PROMPT], cfg, TWIN_LEN)
            decs = []
            for pos in range(TWIN_PROMPT, TWIN_LEN):
                dl, cache = tf.decode_step(
                    params, cache, t[:, pos:pos + 1],
                    torch.tensor(pos, dtype=torch.int32), cfg)
                decs.append(dl)
        out.append({"logits": logits, "loss": loss.detach(),
                    "grads": grads, "cache": mp.flatten(cache),
                    "decode": torch.stack(decs)})
    c, h = out
    err = {k: rel_err(c[k], h[k]) for k in ("logits", "loss", "decode")}
    err["grads"] = max(rel_err(v, h["grads"][k])
                       for k, v in c["grads"].items())
    err["cache"] = max(rel_err(v.float(), h["cache"][k].float())
                       for k, v in c["cache"].items())
    if (max(err["logits"], err["loss"], err["decode"], err["cache"])
            > LM_FWD_TOL or err["grads"] > LM_GRAD_TOL):
        fail(f"lm (c) {name}: card differs from the CPU: {err}")
    return err


def seqrec_twin(dev, name: str) -> dict:
    """(c): a sequential recommender's smoke config on the card and on the
    CPU: the encoding, the loss with one raw key, its gradients, and
    `topk_over_catalog` (ids equal)."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.data import recsys_stream
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    cfg = registry.get(name).smoke_cfg
    loss_fn = rs.sasrec_loss if name == "sasrec" else rs.bert4rec_loss
    p0 = convert.params_to_numpy(mp.init_tree(rs.sasrec_specs(cfg), SEED,
                                              "cpu"))
    b = recsys_stream.seq_batch(0, 0, 1, global_batch=64,
                                n_items=cfg.n_items, seq_len=cfg.seq_len)
    out = []
    for d in (dev, torch.device("cpu")):
        batch = {k: torch.from_numpy(v).to(d) for k, v in b.items()}
        leaves = {k: v.requires_grad_() for k, v in mp.flatten(
            convert.params_from_numpy(p0, d)).items()}
        params = mp.unflatten(leaves)
        loss, _ = loss_fn(params, batch, cfg, np.asarray([SEED, 7],
                                                         np.uint32))
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        with torch.no_grad():
            h = rs.sasrec_encode(params, batch["history"], cfg)
            v, ids = rs.topk_over_catalog(params, h[:, -1], cfg, k=20,
                                          chunk=64)
        out.append({"encode": h, "loss": loss.detach(), "grads": grads,
                    "topk": v, "ids": ids})
    c, h = out
    err = {k: rel_err(c[k], h[k]) for k in ("encode", "loss", "topk")}
    err["grads"] = max(rel_err(v, h["grads"][k])
                       for k, v in c["grads"].items())
    if not torch.equal(c["ids"].cpu(), h["ids"]):
        fail(f"lm (c) {name}: topk_over_catalog ids differ card / CPU")
    if (max(err["encode"], err["loss"], err["topk"]) > LM_FWD_TOL
            or err["grads"] > LM_GRAD_TOL):
        fail(f"lm (c) {name}: card differs from the CPU: {err}")
    return err


def seqrec_full(dev, name: str) -> dict:
    """(d): SASRec / BERT4Rec at their full configs (1,000,000 items):
    SEQREC_STEPS train steps at SEQREC_BATCH, `topk_over_catalog` at
    serve_p99 (its values equal to a top-k of the whole catalog's scores
    within LM_FWD_TOL), `score_candidates` at retrieval_cand."""
    from repro_torch.configs import registry
    from repro_torch.data import recsys_stream
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    from repro_torch.train import loop, optimizer
    cfg = registry.get(name).cfg
    loss_fn = rs.sasrec_loss if name == "sasrec" else rs.bert4rec_loss
    bsz = SEQREC_BATCH[name]
    base = fresh_peak()
    params = mp.init_tree(rs.sasrec_specs(cfg), SEED, dev)
    init, step = loop.make_train_step(
        lambda p, b, r: loss_fn(p, b, cfg, r),
        optimizer.OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                  decay_steps=SEQREC_STEPS))
    state = init(params, np.asarray([SEED, 16], np.uint32))
    losses, ms = [], []
    for s in range(SEQREC_STEPS):
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             recsys_stream.seq_batch(s, 0, 1, global_batch=bsz,
                                     n_items=cfg.n_items,
                                     seq_len=cfg.seq_len).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        fail(f"lm (d) {name}: non-finite losses {losses}")
    res = {"batch": bsz, "losses": losses, "train_step_ms": ms}
    peak_report(f"lm (d) {name} train", res, base)
    params = state.params
    del state, step, init
    hist = torch.from_numpy(recsys_stream.seq_batch(
        99, 0, 1, global_batch=SEQREC_USERS, n_items=cfg.n_items,
        seq_len=cfg.seq_len)["history"]).to(dev)
    cand = torch.arange(cfg.n_items, dtype=torch.int32, device=dev)

    def serve():
        h = rs.sasrec_encode(params, hist, cfg)[:, -1]
        return rs.topk_over_catalog(params, h, cfg, k=SEQREC_K)

    def retrieve():
        h = rs.sasrec_encode(params, hist[:1], cfg)[:, -1]
        return rs.score_candidates(params, h, cand)

    with torch.no_grad():
        v, ids = serve()
        h = rs.sasrec_encode(params, hist, cfg)[:, -1]
        full = rs.score_candidates(params, h, cand)
        res["topk_vs_full_catalog"] = rel_err(
            v, torch.topk(full, SEQREC_K, dim=-1).values)
        if res["topk_vs_full_catalog"] > LM_FWD_TOL:
            fail(f"lm (d) {name}: topk_over_catalog values differ from the "
                 f"whole catalog's top-k by {res['topk_vs_full_catalog']}")
        if rel_err(full.gather(1, ids), v) > LM_FWD_TOL:
            fail(f"lm (d) {name}: topk ids do not score their values")
        del full
        res["serve_p99_ms"] = summary([cuda_ms(serve, 1) for _ in range(20)])
        scores = retrieve()
        if scores.shape != (1, cfg.n_items):
            fail(f"lm (d) {name}: retrieval scores {tuple(scores.shape)}")
        res["retrieval_ms"] = summary([cuda_ms(retrieve, 1)
                                       for _ in range(20)])
    del params
    log(f"lm (d): {name} {SEQREC_STEPS} steps at {bsz}: losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in ms]}; topk_over_catalog of {SEQREC_USERS} "
        f"users (k {SEQREC_K}) ms {res['serve_p99_ms']}, == the whole "
        f"catalog's top-k within {res['topk_vs_full_catalog']:.2e}; "
        f"{cfg.n_items} candidates scored, ms {res['retrieval_ms']}")
    return res


def lm_entry_points(dev) -> dict:
    """(e): `launch/train.main` (the reference docstring's accelerator
    recipe, steps cut from 300 to 30) with its sketch against a CPU
    `update_batched` of the same token batches; `launch/serve.main` at
    its defaults; `examples/train_lm_torch.py --preset 25m --steps 20
    --sketch`."""
    import runpy
    from repro_torch.core import sketch as sk
    from repro_torch.data import corpus, pipeline
    from repro_torch.launch import serve, train
    res = {}
    t0 = time.perf_counter()
    steps, batch, seq = E2E_TRAIN
    state, sketch = train.main(["--preset", "100m", "--steps", str(steps),
                                "--batch", str(batch), "--seq", str(seq),
                                "--sketch"])
    torch.cuda.synchronize()
    res["train_100m_s"] = time.perf_counter() - t0
    if int(state.step) != steps:
        fail(f"lm (e): launch.train stopped at step {int(state.step)}")
    del state
    # the CPU's counting of the same batches (steps 0..steps: the batch
    # source runs one step ahead of the loop)
    src = pipeline.token_batch_source(
        corpus.generate(corpus.CorpusSpec(n_tokens=2_000_000)), batch, seq,
        0)
    host = sk.init(sketch.spec, device="cpu")
    for s in range(steps + 1):
        host = sk.update_batched(host, train.sketch_keys(
            src.batch(s, 0, 1)["tokens"], "cpu"),
            np.asarray([0, s], np.uint32), eager=False)
    cells = sk.logical_table(host.table, host.spec)
    res["sketch_cells"] = int(cells.numel())
    res["sketch_cells_apart"] = int(
        (sk.logical_table(sketch.table, sketch.spec).cpu() != cells).sum())
    if res["sketch_cells_apart"]:
        fail(f"lm (e): the --sketch table is {res['sketch_cells_apart']} "
             f"cells from the CPU's")
    log(f"lm (e): launch.train --preset 100m --steps {steps} --batch "
        f"{batch} --seq {seq} --sketch in {res['train_100m_s']:.1f} s; its "
        f"sketch equals the CPU's update_batched cell for cell "
        f"({res['sketch_cells']} cells)")
    t0 = time.perf_counter()
    _, _, toks = serve.main(["--arch", "qwen2-0.5b"])
    res["serve_s"] = time.perf_counter() - t0
    if tuple(toks.shape) != (4, 32):
        fail(f"lm (e): launch.serve generated {tuple(toks.shape)}")
    argv = sys.argv
    sys.argv = ["train_lm_torch.py", "--preset", "25m", "--steps", "20",
                "--sketch"]
    t0 = time.perf_counter()
    try:
        runpy.run_path(str(pathlib.Path(__file__).resolve().parent
                           / "examples" / "train_lm_torch.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    res["example_25m_s"] = time.perf_counter() - t0
    log(f"lm (e): launch.serve at its defaults in {res['serve_s']:.1f} s; "
        f"examples/train_lm_torch.py --preset 25m --steps 20 --sketch in "
        f"{res['example_25m_s']:.1f} s")
    return res


def lm_profiles(dev) -> dict:
    """Phase 12's profiles of the LM path: one qwen2-0.5b train step at
    LM_BATCH x LM_SEQ (after one warm-up step), one prefill of SERVE_BATCH
    x SERVE_PROMPT and one decode step on its cache, each under
    torch.profiler (device busy and idle share, launches, top kernels)."""
    from repro_torch.configs import qwen2_05b
    from repro_torch.data import corpus, pipeline
    from repro_torch.models import params as mp
    from repro_torch.models import transformer as tf
    from repro_torch.train import loop, optimizer
    cfg = qwen2_05b.CFG
    params = mp.init_tree(tf.param_specs(cfg), SEED, dev)
    src = pipeline.token_batch_source(
        corpus.generate(corpus.CorpusSpec(n_tokens=500_000)), LM_BATCH,
        LM_SEQ, SEED)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in src.batch(0, 0, 1).items()}
    init, step = loop.make_train_step(
        lambda p, b, r: tf.loss_fn(p, b, cfg),
        optimizer.OptimizerConfig(peak_lr=LM_LR, warmup_steps=0,
                                  decay_steps=LM_STEPS))
    held = {"state": init(params, np.asarray([SEED, 15], np.uint32)),
            "pos": torch.full((), SERVE_PROMPT, dtype=torch.int32,
                              device=dev)}
    prompt = batch["tokens"][:1, :SERVE_PROMPT].expand(SERVE_BATCH, -1)

    def train_step():
        held["state"], _ = step(held["state"], batch)

    def prefill():
        with torch.no_grad():
            held["logits"], held["cache"] = tf.prefill(
                held["state"].params, prompt, cfg,
                max_len=SERVE_PROMPT + SERVE_GEN)

    def decode_step():
        with torch.no_grad():
            tf.decode_step(held["state"].params, held["cache"],
                           torch.argmax(held["logits"], -1)[:, None],
                           held["pos"], cfg)

    train_step()
    prefill()
    decode_step()
    res = {}
    for what, drive in (("qwen2_train_step", train_step),
                        ("qwen2_prefill_2k", prefill),
                        ("qwen2_decode_step", decode_step)):
        prof = profile_epoch(drive)
        res[what] = prof
        log(f"one {what} under torch.profiler: wall {prof['wall_ms']:.3f} "
            f"ms, device busy {prof['device_busy_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.3f}, runtime calls "
            f"{prof['runtime_calls']}; device top "
            f"{[(r['name'][:48], round(r['ms'], 3), r['count']) for r in prof['device_top'][:6]]}")
    return res


def lm_phase(dev) -> tuple:
    """Phase 15: the LM and sequential-recommender scaffold, (a)-(e), TF32
    off.  Returns (kernel launches, the numbers it reports)."""
    from repro_torch.kernels import sketch as ksk
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    res = {"live_before_bytes": torch.cuda.memory_allocated(),
           "peak_before_bytes": torch.cuda.max_memory_allocated()}
    res["qwen2"] = qwen_full(dev)
    res["other_lms"] = other_lms(dev)
    res["twins"] = {n: lm_twin(dev, n) for n in (
        "qwen2-0.5b", "phi3-mini-3.8b", "gemma2-27b",
        "llama4-scout-17b-a16e", "deepseek-v2-lite-16b")}
    res["twins"].update({n: seqrec_twin(dev, n)
                         for n in ("sasrec", "bert4rec")})
    log(f"lm (c): seven smoke configs card == CPU within {LM_FWD_TOL} / "
        f"{LM_GRAD_TOL}: {res['twins']}")
    res["seqrec"] = {n: seqrec_full(dev, n) for n in ("sasrec", "bert4rec")}
    res["entry_points"] = lm_entry_points(dev)
    res["peak_bytes"] = max(
        [res["peak_before_bytes"], torch.cuda.max_memory_allocated()]
        + [r["peak_bytes"] for r in (
            res["qwen2"]["train"], res["qwen2"]["serve_2k"],
            res["qwen2"]["decode_32k"], *res["other_lms"].values(),
            *res["seqrec"].values())])
    fresh_peak()
    launches = dict(ksk.kernel_launches())
    res["seconds"] = time.perf_counter() - t0
    log(f"lm phase: {res['seconds']:.1f} s; launches {launches} (no kernel "
        f"lies on this path)")
    return launches, res


# ---- phase 16 of slice 13: DimeNet, and the routed exchange on NCCL --------

GNN_STEPS = 5              # train steps a regime
GNN_PEAK_LIMIT = 60 * 2**30  # a regime's step peak above what is live
# ogb_products' published 61,859,140 edges do not fit one card: at d_hidden
# 128 a (T, d) float32 tensor of its 123,718,280 triplets is 63.3 GB alone,
# and a checkpointed block's backward holds several (E, d) and (T, d)
# tensors.  Cut to OGB_EDGES, which keeps the step's peak below
# GNN_PEAK_LIMIT (the measured peak per edge is printed and in PERF.md).
OGB_EDGES = 3_670_016
MINIBATCH_BASE_EDGES = 114_615_892   # published (GNN_SHAPES), not cut
LABEL_MAX_DEGREE = 64      # whole-graph regimes: labeled nodes' in-degree
GNN_TWIN_FWD = 1e-5        # DimeNet card against CPU, normwise (atomics)
GNN_TWIN_GRAD = 1e-4
MOE_TOKENS = 8_192         # deepseek-v2-lite's MoE widths, float32
MOE_TOL = 1e-5
ALLREDUCE_FLOATS = 16 * 2**20   # a 64 MiB float32 gradient
ROUTE_ROWS, ROUTE_CAP = 100_000, 65_536
SPARSE_STEPS = 12          # dlrm_train_step_sparse steps at REC_BATCH


def pad512(n: int) -> int:
    """Edge lists padded to a multiple of 512 (the reference's cells)."""
    return n + (-n) % 512


def gnn_graph_batch(src, dst, n_nodes: int, max_angular: int, rng,
                    edge_mask=None) -> dict:
    """Edge and triplet lists of a graph, edges padded to a multiple of
    512 with masked (0 -> 0) edges, triplets sampled over the padded list
    and masked where they touch a padded or masked edge (numpy)."""
    from repro_torch.data import graph
    e = src.size
    ep = pad512(e)
    mask = np.zeros(ep, np.float32)
    mask[:e] = 1.0 if edge_mask is None else edge_mask
    src = np.concatenate([src, np.zeros(ep - e, np.int32)]).astype(np.int32)
    dst = np.concatenate([dst, np.zeros(ep - e, np.int32)]).astype(np.int32)
    kj, ji, valid = graph.build_triplets(src, dst, n_nodes, max_angular, rng)
    t_mask = valid.astype(np.float32) * mask[kj] * mask[ji]
    return {"edge_src": src, "edge_dst": dst, "edge_mask": mask,
            "t_kj": kj, "t_ji": ji, "t_mask": t_mask}


def mask_zero_length(b: dict) -> dict:
    """Mask the edges of length 0 (a self-loop, or a sampled edge from a
    node to itself) and the triplets touching them: such an edge has no
    direction, and `_envelope` at r = 1e-6 is 5e6, so a few of them set
    every activation's scale (a power-law `synthetic_graph` draws 14% of
    its edges as 0 -> 0).  The CPU tests keep them, against the
    reference."""
    keep = (b["pos"][b["edge_src"].long()]
            != b["pos"][b["edge_dst"].long()]).any(dim=-1)
    b["edge_mask"] = b["edge_mask"] * keep
    b["t_mask"] = (b["t_mask"] * b["edge_mask"][b["t_kj"].long()]
                   * b["edge_mask"][b["t_ji"].long()])
    return b


def learnable_labels(feats: torch.Tensor, n_classes: int, gen):
    """Node labels the features determine: the argmax of a fixed random
    projection (random labels give a loss that need not fall in five
    steps)."""
    proj = torch.randn((feats.shape[1], n_classes), generator=gen,
                       device=feats.device)
    return torch.argmax(feats @ proj, dim=1).to(torch.int32)


def gnn_regime_data(name: str, sp: dict, dev):
    """(config, first batch on the card, batch of step s (None: the same
    batch every step), sizes, host seconds to build the data) of one
    GNN_SHAPES regime at its published shape (OGB_EDGES for ogb_products)."""
    import dataclasses
    from repro_torch.configs import dimenet as dcfg
    from repro_torch.data import graph
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    up = lambda b: {k: torch.from_numpy(v).to(dev) if isinstance(  # noqa
        v, np.ndarray) else v for k, v in b.items()}
    sizes = {}
    if name == "molecule":
        cfg = dataclasses.replace(dcfg.CFG, readout="graph", n_targets=1)
        m = graph.batched_molecules(sp["batch"], sp["n_nodes"],
                                    sp["n_edges"], seed=SEED)
        b = gnn_graph_batch(m["edge_src"], m["edge_dst"], m["pos"].shape[0],
                            sp["max_angular"], rng)
        b.update(pos=m["pos"], atom_z=m["atom_z"], graph_id=m["graph_id"],
                 n_graphs=m["n_graphs"],
                 target=rng.normal(size=sp["batch"]).astype(np.float32))
        batch, later = up(b), None
    elif name == "minibatch_lg":
        cfg = dataclasses.replace(dcfg.CFG, readout="node",
                                  d_feat=sp["d_feat"],
                                  n_targets=sp["n_classes"])
        base = graph.synthetic_graph(sp["base_nodes"], MINIBATCH_BASE_EDGES,
                                     seed=SEED)
        sizes["base_graph_s"] = time.perf_counter() - t0
        n_base = base.n_nodes
        feats = torch.randn((n_base, sp["d_feat"]), generator=gen,
                            device=dev)
        pos = torch.randn((n_base, 3), generator=gen, device=dev)
        labels = learnable_labels(feats, sp["n_classes"], gen)

        def later(step: int) -> dict:
            r = np.random.default_rng((SEED, 16, step))
            seeds = r.choice(n_base, sp["batch_nodes"], replace=False)
            nodes, src, dst, emask = graph.sample_neighbors(
                base, seeds, list(sp["fanout"]), r)
            b = up(gnn_graph_batch(src, dst, nodes.size, sp["max_angular"],
                                   r, emask.astype(np.float32)))
            ids = torch.from_numpy(nodes.astype(np.int64)).to(dev)
            lmask = torch.zeros(nodes.size, device=dev)
            lmask[:sp["batch_nodes"]] = 1.0   # the seeds carry the labels
            b.update(pos=pos[ids], x_feat=feats[ids], label=labels[ids],
                     label_mask=lmask)
            return mask_zero_length(b)
        batch = later(0)
    else:
        cfg = dataclasses.replace(dcfg.CFG, readout="node",
                                  d_feat=sp["d_feat"],
                                  n_targets=sp["n_classes"])
        n = sp["n_nodes"]
        e = OGB_EDGES if name == "ogb_products" else sp["n_edges"]
        g = graph.synthetic_graph(n, e, seed=SEED)
        dst = np.repeat(np.arange(n), np.diff(g.indptr)).astype(np.int32)
        b = up(gnn_graph_batch(g.indices, dst, n, sp["max_angular"], rng))
        feats = torch.randn((n, sp["d_feat"]), generator=gen, device=dev)
        b.update(pos=torch.randn((n, 3), generator=gen, device=dev),
                 x_feat=feats,
                 label=learnable_labels(feats, sp["n_classes"], gen))
        b = mask_zero_length(b)
        # labels on the nodes that receive 1 to LABEL_MAX_DEGREE messages:
        # a node with none has a zero output whatever the weights, and a
        # power-law hub sums hundreds of thousands (38% of the edges end
        # at node 0), so one Adam step sends its logits to 1e4
        deg = torch.zeros(n, device=dev).index_add_(
            0, b["edge_dst"].long(), b["edge_mask"])
        b["label_mask"] = ((deg >= 1) & (deg <= LABEL_MAX_DEGREE)).float()
        sizes["labeled_nodes"] = int(b["label_mask"].sum())
        batch, later = b, None
    sizes.update(nodes=int(batch["pos"].shape[0]),
                 edges=int(batch["edge_src"].numel()),
                 valid_edges=int(batch["edge_mask"].sum()),
                 triplets=int(batch["t_kj"].numel()),
                 valid_triplets=int(batch["t_mask"].sum()))
    torch.cuda.synchronize()
    sizes["data_s"] = time.perf_counter() - t0
    return cfg, batch, later, sizes


def gnn_train(dev, name: str, sp: dict) -> tuple:
    """(a): one regime trained GNN_STEPS steps through `make_train_step`
    (OptimizerConfig() with the warmup cut to 0 steps: its 100-step warmup
    would train these steps at a learning rate of at most 1.2e-5).
    Returns (report, a drive of one more step for phase 12, or None)."""
    from repro_torch.models import dimenet as dn
    from repro_torch.models import params as mp
    from repro_torch.train import loop, optimizer
    base = fresh_peak()
    cfg, batch, later, sizes = gnn_regime_data(name, sp, dev)
    params = mp.init_tree(dn.param_specs(cfg), SEED, dev)
    init, step = loop.make_train_step(
        lambda p, b, r: dn.loss_fn(p, b, cfg),
        optimizer.OptimizerConfig(warmup_steps=0, decay_steps=GNN_STEPS))
    state = init(params, np.asarray([SEED, 16], np.uint32))
    first = batch
    losses, ms, sample_s = [], [], []
    for s in range(GNN_STEPS):
        if later is not None and s:
            t0 = time.perf_counter()
            batch = later(s)
            torch.cuda.synchronize()
            sample_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    res = {"config": {"d_feat": cfg.d_feat, "n_targets": cfg.n_targets,
                      "readout": cfg.readout}, **sizes,
           "losses": losses, "step_ms": ms}
    if later is not None:
        # fresh subgraphs each step: the first one's loss, before and after
        with torch.no_grad():
            res["first_batch_loss_after"] = float(dn.loss_fn(
                state.params, first, cfg)[0])
        res["sample_s"] = summary(sample_s)
        falling = res["first_batch_loss_after"] < losses[0]
    else:
        falling = losses[-1] < losses[0]
    steady = float(np.median(ms[1:]))
    flops = dn.model_flops(cfg, sizes["nodes"], sizes["edges"],
                           sizes["triplets"], cfg.d_feat)
    res.update(step_ms_first=ms[0], step_ms_steady=steady,
               edges_per_s=sizes["edges"] / steady * 1e3,
               model_flops_per_step=flops,
               model_flops_per_s=flops / steady * 1e3)
    peak_report(f"gnn (a) {name}", res, base)
    res["peak_bytes_per_edge"] = res["peak_above_live_bytes"] / sizes["edges"]
    if not (all(np.isfinite(losses)) and falling):
        fail(f"gnn (a) {name}: losses not finite and falling: {res}")
    if res["peak_above_live_bytes"] >= GNN_PEAK_LIMIT:
        fail(f"gnn (a) {name}: step peak {res['peak_above_live_bytes']} B "
             f"above what is live")
    log(f"gnn (a) {name}: {sizes['nodes']} nodes, {sizes['edges']} edges, "
        f"({sizes['valid_edges']} valid), {sizes['triplets']} triplets "
        f"({sizes['valid_triplets']} valid), "
        + (f"{sizes['labeled_nodes']} labeled nodes, "
           if "labeled_nodes" in sizes else "")
        + f"data {sizes['data_s']:.1f} s; losses "
        f"{[round(x, 5) for x in losses]}"
        + (f" (first subgraph after: {res['first_batch_loss_after']:.5f})"
           if later is not None else "")
        + f"; step ms first {ms[0]:.1f}, steady {steady:.2f} "
        f"({[round(x, 2) for x in ms]}); {res['edges_per_s']:.3e} edges/s, "
        f"{res['model_flops_per_s'] / 1e12:.2f} model TFLOP/s; peak "
        f"{res['peak_above_live_bytes'] / 2**30:.2f} GiB above live "
        f"({res['peak_bytes_per_edge']:.0f} B an edge)")
    drive = None
    if name == "minibatch_lg":
        held = {"state": state}

        def drive():
            held["state"], _ = step(held["state"], batch)
    del params
    return res, drive


def gnn_twin(dev) -> dict:
    """(a), card against CPU: the two smoke cases (molecules, graph
    readout; a 256-node feature graph, node readout) from the same
    float32 weights with nonzero output heads: outputs, loss and every
    gradient within GNN_TWIN_FWD / GNN_TWIN_GRAD (normwise; the card's
    segment sums add with atomics)."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import dimenet as dcfg
    from repro_torch.data import graph
    from repro_torch.models import dimenet as dn
    from repro_torch.models import params as mp
    res = {}
    for readout in ("graph", "node"):
        rng = np.random.default_rng(SEED + 3)
        if readout == "graph":
            cfg = dataclasses.replace(dcfg.SMOKE, readout="graph")
            m = graph.batched_molecules(8, 12, 24, seed=SEED)
            b = gnn_graph_batch(m["edge_src"], m["edge_dst"], 96, 4, rng)
            b.update(pos=m["pos"], atom_z=m["atom_z"], graph_id=m["graph_id"],
                     n_graphs=8,
                     target=rng.normal(size=8).astype(np.float32))
        else:
            cfg = dataclasses.replace(dcfg.SMOKE, readout="node", d_feat=8,
                                      n_targets=5)
            g = graph.synthetic_graph(256, 2048, seed=SEED + 1)
            dst = np.repeat(np.arange(256), np.diff(g.indptr)).astype(
                np.int32)
            b = gnn_graph_batch(g.indices, dst, 256, 3, rng)
            b.update(pos=rng.normal(size=(256, 3)).astype(np.float32),
                     x_feat=rng.normal(size=(256, 8)).astype(np.float32),
                     label=rng.integers(0, 5, 256).astype(np.int32))
        p0 = mp.unflatten({
            k: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(
                np.float32)
            for k, s in mp.flatten(dn.param_specs(cfg)).items()})
        runs = []
        for d in (dev, torch.device("cpu")):
            batch = {k: torch.from_numpy(v).to(d) if isinstance(v, np.ndarray)
                     else v for k, v in b.items()}
            leaves = {k: v.requires_grad_() for k, v in mp.flatten(
                convert.params_from_numpy(p0, d)).items()}
            loss, _ = dn.loss_fn(mp.unflatten(leaves), batch, cfg)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                out = dn.apply(mp.unflatten(leaves), batch, cfg)
            runs.append((out, loss.detach(), dict(zip(leaves, grads))))
        (oc, lc, gc), (oh, lh, gh) = runs
        r = {"output": rel_err(oc, oh), "loss": rel_err(lc, lh),
             "grads": max(rel_err(g, gh[k]) for k, g in gc.items())}
        if not (r["output"] <= GNN_TWIN_FWD and r["loss"] <= GNN_TWIN_FWD
                and r["grads"] <= GNN_TWIN_GRAD):
            fail(f"gnn (a) {readout} readout card against CPU: {r}")
        res[readout] = r
    log(f"gnn (a) card against CPU (smoke configs, normwise; tolerance "
        f"{GNN_TWIN_FWD} / {GNN_TWIN_GRAD}): {res}")
    return res


def routed_check(dev, tmp: str, tables, sparse_cfg) -> dict:
    """(b): the routed exchange on a one-rank NCCL group, each routed form
    against its unrouted one: route / send_back with drops, moe_apply_a2a
    at deepseek-v2-lite's MoE widths (float32, capacity factors no token
    overflows) within MOE_TOL of moe_apply, compressed_allreduce_mean on a
    64 MiB gradient == dequantize(quantize(g)), dlrm_lookup_a2a on (c)'s
    tables == dlrm_lookup, DimeNet's loss_fn_sharded == loss_fn."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import convert, routing
    from repro_torch.configs import deepseek_v2_lite, dimenet as dcfg
    from repro_torch.data import graph, recsys_stream
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import dimenet as dn
    from repro_torch.models import moe
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    from repro_torch.train import compression
    res = {}
    mesh_lib.init_group(1, 0, backend="nccl", init_file=f"{tmp}/store16")
    try:
        mesh = mesh_lib.make_host_mesh(1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 161)
        x = torch.randn((ROUTE_ROWS, 16), generator=gen, device=dev)
        dest = torch.zeros(ROUTE_ROWS, dtype=torch.int64, device=dev)
        recv, rt = routing.route(x, dest, ROUTE_CAP)
        back = routing.send_back(recv * 2.0, rt)
        kept = int(rt.kept.sum())
        if not (kept == ROUTE_CAP and torch.equal(back[rt.kept],
                                                  x[rt.kept] * 2.0)
                and not bool(back[~rt.kept].any())):
            fail(f"routed (b): route / send_back round trip ({kept} kept)")
        res["route"] = {"rows": ROUTE_ROWS, "capacity": ROUTE_CAP,
                        "dropped": ROUTE_ROWS - kept}

        c = dataclasses.replace(
            deepseek_v2_lite.CFG.moe,
            capacity_factor=deepseek_v2_lite.CFG.moe.n_experts
            / deepseek_v2_lite.CFG.moe.top_k)
        p = mp.init_tree(moe.moe_specs(c), SEED, dev)
        xt = torch.randn((MOE_TOKENS, c.d_model), generator=gen, device=dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_a, aux_a = moe.moe_apply_a2a(p, xt, c)
            torch.cuda.synchronize()
            a2a_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            y, aux = moe.moe_apply(p, xt, c)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((y_a - y).abs().max())
        if not (err < MOE_TOL and float((aux_a - aux).abs()) < MOE_TOL):
            fail(f"routed (b): moe_apply_a2a differs from moe_apply by {err}")
        res["moe"] = {"tokens": MOE_TOKENS, "max_abs": err,
                      "a2a_ms": a2a_ms, "moe_apply_ms": plain_ms}
        del p, xt, y_a, y

        g = torch.randn(ALLREDUCE_FLOATS, generator=gen, device=dev)
        want = compression.dequantize(*compression.quantize(g), g.shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = compression.compressed_allreduce_mean(g)
        torch.cuda.synchronize()
        ar_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            fail("routed (b): compressed_allreduce_mean != "
                 "dequantize(quantize(g))")
        res["allreduce"] = {"bytes": g.numel() * 4, "ms": ar_ms}
        del g, want, got

        b = recsys_stream.dlrm_batch(0, 0, 1, global_batch=REC_BATCH,
                                     table_sizes=list(sparse_cfg.table_sizes),
                                     seed=SEED)
        ids = torch.from_numpy(b["sparse"]).to(dev)
        with torch.no_grad():
            if not torch.equal(rs.dlrm_lookup_a2a(tables, ids, sparse_cfg,
                                                  mesh),
                               rs.dlrm_lookup(tables, ids, sparse_cfg)):
                fail("routed (b): dlrm_lookup_a2a != dlrm_lookup")
        res["dlrm_lookup"] = {"batch": REC_BATCH,
                              "sharded_fields": sum(rs.field_sharded(
                                  sparse_cfg))}

        cfg = dataclasses.replace(dcfg.SMOKE, readout="node", d_feat=8,
                                  n_targets=5)
        rng = np.random.default_rng(SEED + 5)
        gr = graph.synthetic_graph(256, 2048, seed=SEED + 1)
        dst = np.repeat(np.arange(256), np.diff(gr.indptr)).astype(np.int32)
        gb = gnn_graph_batch(gr.indices, dst, 256, 3, rng)
        gb.update(pos=rng.normal(size=(256, 3)).astype(np.float32),
                  x_feat=rng.normal(size=(256, 8)).astype(np.float32),
                  label=rng.integers(0, 5, 256).astype(np.int32))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in gb.items()}
        gp = convert.params_from_numpy(mp.unflatten({
            k: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(
                np.float32)
            for k, s in mp.flatten(dn.param_specs(cfg)).items()}), dev)
        with torch.no_grad():
            ls, _ = dn.loss_fn_sharded(gp, batch, cfg)
            lw, _ = dn.loss_fn(gp, batch, cfg)
        res["dimenet_sharded_rel"] = rel_err(ls, lw)
        if res["dimenet_sharded_rel"] > GNN_TWIN_FWD:
            fail(f"routed (b): loss_fn_sharded != loss_fn "
                 f"({res['dimenet_sharded_rel']})")
    finally:
        dist.destroy_process_group()
    log(f"routed (b) at world size 1 on NCCL: {res}")
    return res


def sparse_step_check(dev, cfg, tables) -> dict:
    """(c): `dlrm_train_step_sparse` (the unrouted branch) at dlrm-mlperf's
    widths on 26 tables of 1,049,600 rows (phase 14's gated shape; ids
    drawn by `dlrm_batch` over those rows, no admission), SPARSE_STEPS
    steps of REC_BATCH: finite losses, every row no id touched
    bit-identical, touched rows moved; step ms and the peak."""
    from repro_torch.data import recsys_stream
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    from repro_torch.train import optimizer
    base = fresh_peak()
    opt = optimizer.OptimizerConfig(peak_lr=2e-3, warmup_steps=2,
                                    decay_steps=REC_STEPS)
    _, dense_update = optimizer.make_optimizer(opt,
                                               label_fn=lambda p: "dense")
    specs = rs.dlrm_specs(cfg)
    params = {"tables": tables, **mp.init_tree(
        {"bot": specs["bot"], "top": specs["top"]}, SEED, dev)}
    state = {"dense": {k: {n: {"mu": torch.zeros_like(t),
                               "nu": torch.zeros_like(t)}
                           for n, t in params[k].items()}
                       for k in ("bot", "top")},
             "tables": {k: {"acc": torch.zeros(t.shape[0], device=dev)}
                        for k, t in tables.items()}}
    start = {k: v.clone() for k, v in tables.items()}
    touched = {k: torch.zeros(v.shape[0], dtype=torch.bool, device=dev)
               for k, v in tables.items()}
    batches = [to_dev(recsys_stream.dlrm_batch(
        s, 0, 1, global_batch=REC_BATCH, table_sizes=list(cfg.table_sizes),
        seed=SEED), dev) for s in range(SPARSE_STEPS)]
    losses, ms = [], []
    for s, b in enumerate(batches):
        for i in range(cfg.n_sparse):
            touched[f"t{i}"][b["sparse"][:, i].long()] = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = rs.dlrm_train_step_sparse(
            params, state, b, s, SEED, cfg, opt, dense_update)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        fail(f"sparse (c): non-finite losses {losses}")
    bad = moved = n_touched = 0
    for k, t in tables.items():
        diff = (t.view(torch.int32) != start[k].view(torch.int32)).any(dim=1)
        bad += int((diff & ~touched[k]).sum())
        moved += int(diff.sum())
        n_touched += int(touched[k].sum())
    if bad or not moved:
        fail(f"sparse (c): {bad} untouched rows changed, {moved} moved")
    res = {"losses": losses, "step_ms": summary(ms), "rows_touched":
           n_touched, "rows_moved": moved}
    peak_report("sparse (c)", res, base)
    del start, batches
    log(f"sparse (c): dlrm_train_step_sparse, {SPARSE_STEPS} steps of "
        f"{REC_BATCH} x 26 on 26 x {cfg.table_sizes[0]}-row tables: losses "
        f"{[round(x, 5) for x in losses]}; step ms {res['step_ms']}; rows "
        f"touched {n_touched}, moved {moved}, untouched bit-identical; peak "
        f"{res['peak_above_live_bytes'] / 2**30:.2f} GiB above live")
    return res


def sparse_twin(dev) -> dict:
    """(c), card against CPU: one `dlrm_train_step_sparse` of the full MLP
    widths on 26 x 5,120-row tables at batch TWIN_BATCH from the same
    weights: loss within FWD_TOL, tables and dense leaves within
    STEP_TOL (normwise)."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.data import recsys_stream
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    from repro_torch.train import optimizer
    cfg = dataclasses.replace(dlrm_mlperf.CFG, table_sizes=(5_120,) * 26)
    p0 = convert.params_to_numpy(mp.init_tree(rs.dlrm_specs(cfg), SEED,
                                              "cpu"))
    b = recsys_stream.dlrm_batch(0, 0, 1, global_batch=TWIN_BATCH,
                                 table_sizes=list(cfg.table_sizes), seed=SEED)
    opt = optimizer.OptimizerConfig(table_lr=0.1)
    _, dense_update = optimizer.make_optimizer(opt,
                                               label_fn=lambda p: "dense")
    runs = []
    for d in (dev, torch.device("cpu")):
        params = convert.params_from_numpy(p0, d)
        state = {"dense": {k: {n: {"mu": torch.zeros_like(t),
                                   "nu": torch.zeros_like(t)}
                               for n, t in params[k].items()}
                           for k in ("bot", "top")},
                 "tables": {k: {"acc": torch.zeros(t.shape[0], device=d)}
                            for k, t in params["tables"].items()}}
        params, state, m = rs.dlrm_train_step_sparse(
            params, state, to_dev(b, d), 0, SEED, cfg, opt, dense_update)
        runs.append((m["loss"], params))
    res = {"loss": rel_err(runs[0][0], runs[1][0]),
           "params": tree_rel_err(runs[0][1], runs[1][1])}
    if not (res["loss"] <= FWD_TOL and res["params"] <= STEP_TOL):
        fail(f"sparse (c) card against CPU: {res}")
    log(f"sparse (c) card against CPU (batch {TWIN_BATCH}, 5,120-row "
        f"tables, one step): {res} (tolerance {FWD_TOL} / {STEP_TOL})")
    return res


def gnn_phase(dev) -> tuple:
    """Phase 16: DimeNet at CFG widths in the four GNN_SHAPES regimes and
    its card-against-CPU twins (a), the routed exchange at world size 1 on
    NCCL (b), `dlrm_train_step_sparse` at dlrm-mlperf's widths (c); TF32
    off.  Returns (kernel launches, the numbers it reports, a drive of one
    minibatch_lg DimeNet step for phase 12's profile)."""
    import dataclasses
    import gc
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.configs import registry
    from repro_torch.core import admission as adm
    from repro_torch.kernels import sketch as ksk
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    res = {"live_before_bytes": torch.cuda.memory_allocated(),
           "regimes": {}}
    drive = None
    for name, sp in registry.GNN_SHAPES.items():
        res["regimes"][name], d = gnn_train(dev, name, sp)
        drive = drive or d
        gc.collect()
    res["twin"] = gnn_twin(dev)
    aspec = adm.AdmissionSpec()
    cfg = dataclasses.replace(
        dlrm_mlperf.CFG,
        table_sizes=(aspec.n_fallback + aspec.table_rows,) * 26)
    base = fresh_peak()
    tables = mp.init_tree(rs.dlrm_specs(cfg)["tables"], SEED, dev)
    res["table_bytes"] = torch.cuda.memory_allocated() - base
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        res["routed"] = routed_check(dev, tmp, tables, cfg)
    res["sparse"] = sparse_step_check(dev, cfg, tables)
    del tables
    gc.collect()
    res["sparse_twin"] = sparse_twin(dev)
    res["peak_bytes"] = max(
        [torch.cuda.max_memory_allocated(), res["sparse"]["peak_bytes"]]
        + [r["peak_bytes"] for r in res["regimes"].values()])
    fresh_peak()
    launches = dict(ksk.kernel_launches())
    res["seconds"] = time.perf_counter() - t0
    log(f"gnn phase: {res['seconds']:.1f} s; launches {launches} (no kernel "
        f"lies on this path)")
    return launches, res, drive


# ---- phase 17 of slice 14: GSPMD placement on DTensor, the dry run --------

P17_LOSS_TOL = 1e-5        # meshed against unmeshed losses, relative
P17_PARAM_TOL = 1e-4       # parameters after the steps, normwise
# one cell a family, each the reference's baseline cell
DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k"),
                ("dlrm-mlperf", "serve_p99"),
                ("dimenet", "molecule"))
DRYRUN_TIMEOUT = 900       # seconds for the subprocess of (c) and (d)


def world1_bound(specs, batch_specs, loss, opt_cfg, label_fn=None) -> dict:
    """The H100 roofline of one full train step (gradients and the
    optimizer's update) at world size 1, counted on fake tensors."""
    from repro_torch.launch import cells
    from repro_torch.models.params import P, abstract_tree
    from repro_torch.roofline import op_stats
    from repro_torch.roofline.analyze import analyze
    with op_stats.counting() as st:
        params, opt = cells._abstract_state(specs, None, None, label_fn)
        step = cells._train_wrapper(loss, opt_cfg, label_fn)
        step(params, opt, abstract_tree(batch_specs),
             abstract_tree(P((), None, "zeros", torch.int32)), None)
        del params, opt
    r = analyze(st, 1)
    terms = {"compute": r.t_compute, "memory": r.t_memory}
    return {"bound_ms": max(terms.values()) * 1e3, "bound_by": r.bottleneck,
            "t_compute_ms": r.t_compute * 1e3, "t_memory_ms": r.t_memory * 1e3,
            "flops": r.flops, "bytes": r.bytes_accessed,
            "peak_bytes": r.peak_memory_bytes}


def world1_bounds(gnn: dict) -> dict:
    """(d)'s three bounds: phase 15's qwen2-0.5b step, phase 16's DimeNet
    minibatch_lg step at `gnn`'s sizes and config, phase 14's DLRM step."""
    import dataclasses
    from repro_torch.configs import dimenet as dn_cfg
    from repro_torch.configs import dlrm_mlperf, qwen2_05b
    from repro_torch.core import admission as adm
    from repro_torch.models import dimenet as dn
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import P
    from repro_torch.train.optimizer import OptimizerConfig, default_label_fn
    i32, f32 = torch.int32, torch.float32
    out = {}
    cfg = qwen2_05b.CFG
    out["qwen2_train"] = world1_bound(
        tf.param_specs(cfg),
        {k: P((LM_BATCH, LM_SEQ), None, "zeros", i32)
         for k in ("tokens", "targets")},
        lambda p, b, r: tf.loss_fn(p, b, cfg),
        OptimizerConfig(peak_lr=LM_LR, warmup_steps=0,
                        decay_steps=LM_STEPS))
    gcfg = dataclasses.replace(dn_cfg.CFG, **gnn["config"])
    n, e, t = gnn["nodes"], gnn["edges"], gnn["triplets"]
    out["dimenet_minibatch_lg"] = world1_bound(
        dn.param_specs(gcfg),
        {"pos": P((n, 3), None, "zeros", f32),
         "x_feat": P((n, gcfg.d_feat), None, "zeros", f32),
         "label": P((n,), None, "zeros", i32),
         "label_mask": P((n,), None, "zeros", f32),
         "edge_src": P((e,), None, "zeros", i32),
         "edge_dst": P((e,), None, "zeros", i32),
         "edge_mask": P((e,), None, "zeros", f32),
         "t_kj": P((t,), None, "zeros", i32),
         "t_ji": P((t,), None, "zeros", i32),
         "t_mask": P((t,), None, "zeros", f32)},
        lambda p, b, r: dn.loss_fn(p, b, gcfg),
        OptimizerConfig(warmup_steps=0, decay_steps=GNN_STEPS))
    aspec = adm.AdmissionSpec()
    rcfg = dataclasses.replace(
        dlrm_mlperf.CFG,
        table_sizes=(aspec.n_fallback + aspec.table_rows,) * 26)
    out["dlrm_train"] = world1_bound(
        rs.dlrm_specs(rcfg),
        {"dense": P((REC_BATCH, rcfg.n_dense), None, "zeros", f32),
         "sparse": P((REC_BATCH, rcfg.n_sparse), None, "zeros", i32),
         "label": P((REC_BATCH,), None, "zeros", f32)},
        lambda p, b, r: rs.dlrm_loss(p, b, rcfg),
        OptimizerConfig(peak_lr=2e-3, warmup_steps=2, decay_steps=REC_STEPS),
        default_label_fn)
    return out


def dryrun_child(spec_path: str, out_path: str) -> None:
    """Phase 17 (c) and (d)'s bounds, in a process of its own (a process
    holds one fake group) that never touches the card."""
    from repro_torch.launch import dryrun
    with open(spec_path) as f:
        spec = json.load(f)
    res = {"cells": []}
    for arch, shape in DRYRUN_CELLS:
        for multi_pod in (False, True):
            rec = dryrun.run_cell(arch, shape, multi_pod, spec["out_dir"],
                                  force=True)
            row = {k: rec.get(k) for k in ("arch", "shape", "mesh", "ok",
                                           "error", "lower_s", "compile_s")}
            if rec["ok"]:
                ro = rec["roofline"]
                row.update(bottleneck=ro["bottleneck"], t_max_ms=1e3 * max(
                    ro["t_compute"], ro["t_memory"], ro["t_collective"]),
                    peak_bytes=ro["peak_memory_bytes"])
            res["cells"].append(row)
    t0 = time.perf_counter()
    res["bounds"] = world1_bounds(spec["gnn"])
    res["bounds_s"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(res, f)


def start_dryrun_child(tmp: str, gnn: dict):
    """The subprocess of (c) and (d), started now and joined by
    `join_dryrun_child`: no card (CUDA_VISIBLE_DEVICES empty)."""
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"out_dir": os.path.join(tmp, "dryrun"), "gnn": gnn}, f)
    root = str(pathlib.Path(__file__).resolve().parent)
    code = ("import sys; sys.path[:0] = [{r!r}, {s!r}]; import chip_smoke; "
            "chip_smoke.dryrun_child({a!r}, {b!r})").format(
        r=root, s=os.path.join(root, "src"), a=spec,
        b=os.path.join(tmp, "out.json"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    log_f = open(os.path.join(tmp, "child.log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            stdout=log_f, stderr=subprocess.STDOUT)
    return proc, log_f


def join_dryrun_child(proc, log_f, tmp: str) -> dict:
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    log_f.close()
    if rc != 0:
        with open(os.path.join(tmp, "child.log")) as f:
            fail(f"placement (c)/(d): the dry-run subprocess ended {rc}: "
                 f"{f.read()[-3000:]}")
    with open(os.path.join(tmp, "out.json")) as f:
        return json.load(f)


def norm_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.clamp(torch.linalg.vector_norm(want), min=1e-30))


def placed_train(dev) -> dict:
    """(a): `launch/train.main --full` on a (1, 1) mesh against unmeshed."""
    import gc
    from repro_torch.launch import train as ttrain
    from repro_torch.models.params import flatten
    args = ["--arch", "qwen2-0.5b", "--full", "--steps", str(LM_STEPS),
            "--batch", str(LM_BATCH), "--seq", str(LM_SEQ), "--lr",
            str(LM_LR), "--seed", str(SEED)]
    res = {}
    plain, meshed = {}, {}
    base = fresh_peak()
    state, _ = ttrain.main(args, record=plain)
    res["plain_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    want = flatten(state.params)
    del state
    gc.collect()
    base = fresh_peak()
    state, _ = ttrain.main(args + ["--mesh"], record=meshed)
    res["mesh_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    got = {k: v.full_tensor() for k, v in flatten(state.params).items()}
    mesh = next(iter(flatten(state.params).values())).device_mesh
    res["mesh"] = {"shape": list(mesh.shape),
                   "names": list(mesh.mesh_dim_names)}
    del state
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(meshed["loss"],
                                                       plain["loss"]))
    param_err = max(norm_rel(got[k], want[k]) for k in want)
    del got, want
    gc.collect()
    res.update(plain=plain, meshed=meshed, loss_rel_err=loss_err,
               param_norm_rel_err=param_err,
               plain_step_ms_median=float(np.median(plain["step_ms"][1:])),
               mesh_step_ms_median=float(np.median(meshed["step_ms"][1:])))
    if not (len(meshed["loss"]) == LM_STEPS and loss_err <= P17_LOSS_TOL
            and param_err <= P17_PARAM_TOL):
        fail(f"placement (a): meshed training departs from unmeshed: losses "
             f"{meshed['loss']} against {plain['loss']} ({loss_err:.3e}), "
             f"parameters {param_err:.3e} normwise")
    return res


def placement_phase(dev, lm_report: dict, gnn_report: dict) -> tuple:
    """Phase 17: GSPMD placement on DTensor (a)-(b) on the card, the dry
    run and the world-size-1 bounds (c)-(d) in a subprocess; TF32 off.
    Returns (kernel launches, the numbers it reports).  The bounds are
    held against phase 14's DLRM step by `check_bounds` after phase 14."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.kernels import sketch as ksk
    from repro_torch.launch import serve as tserve
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.synchronize()
    ksk.reset_kernel_launches()
    tmp = tempfile.mkdtemp(prefix="cml_p17_")
    mb = gnn_report["regimes"]["minibatch_lg"]
    gnn = {"config": mb["config"], "nodes": mb["nodes"],
           "edges": mb["edges"], "triplets": mb["triplets"]}
    proc, log_f = start_dryrun_child(tmp, gnn)
    try:
        res = {"train": placed_train(dev)}
        tr = res["train"]
        log(f"placement (a): qwen2-0.5b on a {tr['mesh']['shape']} "
            f"{tr['mesh']['names']} mesh, {LM_STEPS} steps of {LM_BATCH} x "
            f"{LM_SEQ}: losses {[round(x, 5) for x in tr['meshed']['loss']]} "
            f"against unmeshed {[round(x, 5) for x in tr['plain']['loss']]} "
            f"(max rel {tr['loss_rel_err']:.2e}), parameters "
            f"{tr['param_norm_rel_err']:.2e} apart normwise; ms a step "
            f"meshed {tr['mesh_step_ms_median']:.1f} "
            f"({[round(x, 1) for x in tr['meshed']['step_ms']]}), unmeshed "
            f"{tr['plain_step_ms_median']:.1f}, phase 15's "
            f"{lm_report['qwen2']['train']['step_ms_median']:.1f}; peak "
            f"meshed {tr['mesh_peak_bytes'] / 2**30:.2f} GiB, unmeshed "
            f"{tr['plain_peak_bytes'] / 2**30:.2f} GiB")
        serve_args = ["--arch", "qwen2-0.5b", "--seed", str(SEED)]
        _, _, want = tserve.main(serve_args)
        _, _, got = tserve.main(serve_args + ["--mesh"])
        if not torch.equal(got.cpu(), want.cpu()):
            fail(f"placement (b): meshed serve tokens {got.tolist()} != "
                 f"{want.tolist()}")
        res["serve"] = {"tokens": list(got.shape), "equal": True}
        log(f"placement (b): launch.serve --mesh == launch.serve, "
            f"{tuple(got.shape)} tokens")
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:  # a failed check stops the subprocess too
        proc.kill()
        raise
    child = join_dryrun_child(proc, log_f, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    bad = [c for c in child["cells"] if not c["ok"]]
    if bad:
        fail(f"placement (c): dry-run cells failed: {bad}")
    res["dryrun"] = child["cells"]
    log(f"placement (c): dry-run cells on the fake group: "
        + "; ".join(f"{c['arch']}/{c['shape']}/{c['mesh']} ok ({c['lower_s']} + {c['compile_s']} s, "
                    f"max term "
                    f"{c['t_max_ms']:.3f} ms, {c['bottleneck']})"
                    for c in child["cells"]))
    res["bounds"] = child["bounds"]
    res["bounds_s"] = child["bounds_s"]
    measured = {
        "qwen2_train": lm_report["qwen2"]["train"]["step_ms_median"],
        "dimenet_minibatch_lg": mb["step_ms_steady"]}
    check_bounds(res, measured)
    launches = dict(ksk.kernel_launches())
    res["seconds"] = time.perf_counter() - t0
    log(f"placement phase: {res['seconds']:.1f} s; launches {launches} (no "
        f"kernel lies on this path)")
    return launches, res


def check_bounds(res: dict, measured: dict) -> None:
    """(d): each world-size-1 roofline bound against its measured step;
    a bound above the time measured means the cost model is wrong."""
    for name, ms in measured.items():
        b = res["bounds"][name]
        b["measured_ms"] = ms
        b["measured_over_bound"] = ms / b["bound_ms"]
        log(f"placement (d): {name} bound {b['bound_ms']:.3f} ms "
            f"({b['bound_by']}: compute {b['t_compute_ms']:.3f}, memory "
            f"{b['t_memory_ms']:.3f}; {b['flops']:.3e} FLOPs, "
            f"{b['bytes']:.3e} B) against {ms:.3f} ms measured: ratio "
            f"measured / bound {b['measured_over_bound']:.3f}")
        if b["bound_ms"] > ms:
            fail(f"placement (d): the roofline bound of {name} "
                 f"({b['bound_ms']:.3f} ms) exceeds its measured step "
                 f"({ms:.3f} ms)")


def main(device: str = "cuda") -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root / "tools"))
    sys.path.insert(0, str(root / "examples"))
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
    log(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
        f"{np.__version__}")

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

    # ---- 9. admission and snapshot/restore ----------------------------------
    adm_launches, adm_report, admit_drives = admission_phase(dev, spec,
                                                             stream)

    # ---- 10. hot/cold tiering ----------------------------------------------
    tier_launches, tier_report, tier_drives, tiered_svcs = tiering_phase(
        dev, spec, stream)

    # ---- 11. the sketch and window algebra, the probe, the export ---------
    alg_launches, alg_report, alg_drives = algebra_phase(dev, formats)

    # ---- 13. the repair, the paper's path, sharded at world size 1 --------
    paper_launches, paper_report = paper_phase(dev)

    # ---- 18. the tracked and windowed services, card against CPU ----------
    cpu_launches, cpu_report = card_cpu_phase(dev)

    # ---- 15. the LM and sequential-recommender scaffold --------------------
    # Before phase 14: phase 14's drives keep its 13 GiB of DLRM tables
    # alive for phase 12, and llama4-scout's layers need 41 GiB here.
    lm_launches, lm_report = lm_phase(dev)

    # ---- 16. DimeNet, the routed exchange, the row-sparse DLRM step --------
    # Before phase 14 too (its drives keep 13 GiB alive for phase 12).
    gnn_launches, gnn_report, gnn_drive = gnn_phase(dev)

    # ---- 17. GSPMD placement on DTensor, the dry run ------------------------
    # After 16 (its minibatch_lg sizes feed the bounds), before 14.
    p17_launches, p17_report = placement_phase(dev, lm_report, gnn_report)

    # ---- 14. the sketch-gated recommender path -----------------------------
    rec_launches, rec_report, rec_drives = recsys_phase(dev)
    check_bounds(p17_report, {
        "dlrm_train": rec_report["train"]["train_step_ms"]["median"]})

    # ---- 12. profiles -------------------------------------------------------
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
    for what, drive in zip(("tracked", "windowed"), admit_drives):
        prof = profile_epoch(drive)
        adm_report[f"profile_admit_{what}"] = prof
        log(f"one {what} admit of {BATCH} ids on a clean plane under "
            f"torch.profiler: wall {prof['wall_ms']:.3f} ms, device busy "
            f"{prof['device_busy_ms']:.3f} ms, runtime calls "
            f"{prof['runtime_calls']}, host-to-device copies "
            f"{prof['host_to_device_copies']}; device top "
            f"{[(r['name'][:40], r['count']) for r in prof['device_top']]}")
    for what, prof in (("tracked", profile),
                       ("windowed", e2e2["profile_window_epoch"])):
        log(f"one {what} epoch under torch.profiler: wall "
            f"{prof['wall_ms']:.3f} ms, device busy "
            f"{prof['device_busy_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.3f}, runtime calls "
            f"{prof['runtime_calls']}")
    tier_report["profiles"] = {}
    for what, drive in tier_drives.items():
        prof = profile_epoch(drive)
        tier_report["profiles"][what] = prof
        log(f"one tiered {what} epoch under torch.profiler: wall "
            f"{prof['wall_ms']:.3f} ms, device busy "
            f"{prof['device_busy_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.3f}, runtime calls "
            f"{prof['runtime_calls']}, host-to-device copies "
            f"{prof['host_to_device_copies']}; tier counters "
            f"{tier_counts(tiered_svcs[0 if what != 'windowed' else 1])}")
    alg_report["decayed_query_kernel_alone_ms"] = kernel_device_ms(
        alg_drives["decayed_query"], 50, KERNEL_NAMES["window_query"])
    log(f"kernel 7 alone on the decayed {ALG_HISTORY + 1}-bucket CMLS16 "
        f"leaf, {PROBES} probes: "
        f"{alg_report['decayed_query_kernel_alone_ms']:.5f} ms")
    rec_report["profiles"] = {}
    for what, drive in rec_drives.items():
        prof = profile_epoch(drive)
        rec_report["profiles"][what] = prof
        log(f"one recsys {what} under torch.profiler: wall "
            f"{prof['wall_ms']:.3f} ms, device busy "
            f"{prof['device_busy_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.3f}, runtime calls "
            f"{prof['runtime_calls']}; device top "
            f"{[(r['name'][:48], round(r['ms'], 3), r['count']) for r in prof['device_top'][:6]]}")
    del rec_drives
    lm_report["profiles"] = lm_profiles(dev)
    prof = profile_epoch(gnn_drive)
    gnn_report["profile_minibatch_lg_step"] = prof
    log(f"one DimeNet minibatch_lg train step under torch.profiler: wall "
        f"{prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f} "
        f"ms, idle share {prof['idle_share']:.3f}, runtime calls "
        f"{prof['runtime_calls']}; device top "
        f"{[(r['name'][:48], round(r['ms'], 3), r['count']) for r in prof['device_top'][:8]]}")
    del gnn_drive
    append_host["after_profiler"] = append_host_us(dev, ring, append_calls)
    log("append wrapper host time by part after the profiler sessions, us "
        f"per call: {append_host['after_profiler']}")
    del svc, wsvc, tiered_svcs
    peak = max(tier_report["peak_device_bytes_before"],
               lm_report["peak_bytes"], gnn_report["peak_bytes"],
               rec_report["train"]["peak_before_bytes"],
               rec_report["train"]["peak_bytes"],
               torch.cuda.max_memory_allocated())
    log(f"peak device memory {peak / 2**30:.2f} GiB")

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
                    + flush_launches[name] + read_launches[name]
                    + adm_launches[name] + tier_launches[name]
                    + alg_launches[name] + paper_launches[name]
                    + rec_launches[name] + lm_launches[name]
                    + gnn_launches[name] + p17_launches[name]
                    + cpu_launches[name])
        if launches == 0:
            fail(f"{name} launched on none of the paths")
        log(f"{name} at {rep['shape']}: {rep['ms']:.4f} ms (kernel alone "
            f"{rep['kernel_alone_ms']:.5f} ms, wrapper host "
            f"{rep['host_us']:.1f} us), plain {rep['plain_ms']:.4f} ms, "
            f"library {rep['library_ms']}, bound {max(t_bytes, t_ops):.5f} "
            f"ms ({rep['bytes']} B, {rep['ops']} ops); launches tracked / "
            f"windowed / untracked path / sync-free enqueue / sync-free "
            f"flushes / sync-free reads / admission and snapshots / "
            f"tiering / algebra and probe / paper path / recsys path / "
            f"LM scaffold / graph and routed / placement / card against "
            f"CPU {main_launches[name]} / "
            f"{win_launches[name]} / {flat_launches[name]} / "
            f"{sync_launches[name]} / {flush_launches[name]} / "
            f"{read_launches[name]} / {adm_launches[name]} / "
            f"{tier_launches[name]} / {alg_launches[name]} / "
            f"{paper_launches[name]} / {rec_launches[name]} / "
            f"{lm_launches[name]} / {gnn_launches[name]} / "
            f"{p17_launches[name]} / {cpu_launches[name]}")
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
        "profile_epoch": profile, "window_path": e2e2,
        "admission": adm_report, "tiering": tier_report,
        "algebra": alg_report, "paper": paper_report,
        "recsys": rec_report, "lm": lm_report, "gnn": gnn_report,
        "placement": p17_report, "card_cpu": cpu_report}),
        flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
