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
                64 tenants x 4 MiB), the two ring appends on the 64 x
                65536 ring.  Equality is exact: states, ring cells and
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
  4. times   -- CUDA-event times of each kernel, its plain version and,
                where one exists, a single PyTorch call computing the same
                function; the end-to-end ingest rate and the query_all
                latency.

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
TENANTS = 64
BUDGET = 4_194_304          # bytes per tenant table (configs/paper_sketch.py)
RING = 65_536
TRACK_TOP = 64
MICRO = 8
BATCH = RING // MICRO       # events per tenant per microbatch
PROBES = 1024
SEED = 0


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


def profile_epoch(svc, many) -> dict:
    """Device time by kernel, and host time by op, over one ingest epoch
    (the microbatches' `enqueue_many` + `flush`), from torch.profiler; the
    device's idle share is 1 - busy / wall over the same window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for events in many:
            svc.enqueue_many(events)
        svc.flush()
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
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3),
            "device_top": top(device_rows), "host_top": top(host_rows)}


def main(device: str = "cuda") -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
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
                tk, skeys_u, mult, unif, cand, rows_d, seeds=seeds_of(spec),
                width=spec.width, counter=spec.counter,
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
                                  cand=cand)
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
    qa = base_ring.clone()
    qb = base_ring.clone()
    ksk.queue_append_dense(qa, dense_keys, fill_d, count_d)
    ref.queue_append_dense_plain(qb, dense_keys,
                                 torch.from_numpy(fill_d).to(dev),
                                 torch.from_numpy(count_d).to(dev))
    torch.cuda.synchronize()
    if not torch.equal(signed_view(qa), signed_view(qb)):
        fail("queue_append_dense differs from its plain version")
    log("queue_append_dense: ring equal")
    row_rows = np.array([0, TENANTS // 3, TENANTS - 1])
    row_fill = np.array([RING - BATCH, 5, 0])
    row_count = np.array([BATCH, BATCH - 3, 256])
    row_keys = dense_keys[:3].contiguous()
    qa = base_ring.clone()
    qb = base_ring.clone()
    ksk.queue_append(qa, row_keys, row_rows, row_fill, row_count)
    ref.queue_append_plain(qb, row_keys, torch.from_numpy(row_rows).to(dev),
                           torch.from_numpy(row_fill).to(dev),
                           torch.from_numpy(row_count).to(dev))
    torch.cuda.synchronize()
    if not torch.equal(signed_view(qa), signed_view(qb)):
        fail("queue_append differs from its plain version")
    log("queue_append: ring equal")

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
    missing = [k for k, v in launches.items() if v == 0]
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
    def sectors(spec, keys_i64, mask=None):
        """Distinct 32-byte sectors the keys' cells occupy, per table row."""
        cols = row_hashes(keys_i64, seed_t(spec), spec.width)   # (d, R, N)
        d, r, n = cols.shape
        word_bytes = 4
        cells_per_word = 32 // spec.counter.bits
        sec = (cols // cells_per_word) * word_bytes // SECTOR
        rid = (torch.arange(r, device=dev)[None, :, None] * d
               + torch.arange(d, device=dev)[:, None, None])
        flat = rid * (1 << 40) + sec
        if mask is not None:
            flat = flat[:, mask]
        return int(torch.unique(flat).numel())

    # fused_query at query_all's shape (64 tenants x 1024 probes)
    spec_q = qry_inputs["spec"]
    tq, kq = qry_inputs["tables"], qry_inputs["keys"]
    ms = cuda_ms(lambda: ksk.fused_query(
        tq, kq, seeds=seeds_of(spec_q), width=spec_q.width,
        counter=spec_q.counter), 50)
    pms = cuda_ms(lambda: ref.fused_query_plain(
        tq, kq, seed_t(spec_q), spec_q.width, spec_q.counter), 10)
    nkeys = kq.numel()
    qbytes = nkeys * 8 + sectors(spec_q, kq.view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF) * SECTOR
    qops = nkeys * (spec_q.depth * 12 + 30)
    report["fused_query"] = dict(
        ms=ms, plain_ms=pms, library_ms=None, max_abs_err=qry_err,
        bytes=qbytes, ops=qops,
        shape=f"tables {tuple(tq.shape)} uint16, keys {tuple(kq.shape)}")

    # fused_update_score at the flush epoch's shape (64 rows x 65536 keys)
    u = upd_inputs
    spec_u = u["spec"]
    work = u["tables"].clone()
    src = u["tables"]

    def reset_work():
        work.copy_(src)

    ms = cuda_ms(lambda: ksk.fused_update_score(
        work, u["keys"], u["mult"], u["unif"], u["cand"], rows_d,
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
    ubytes = (r * n * 12 + r * m * 8 + r * 4
              + (2 * upd_sec + cand_sec) * SECTOR)
    n_live = int(live.sum())
    uops = n_live * (spec_u.depth * 14 + 60) + r * m * (spec_u.depth * 12
                                                        + 30)
    report["fused_update_score"] = dict(
        ms=ms, plain_ms=pms, library_ms=None, max_abs_err=upd_err,
        bytes=ubytes, ops=uops,
        shape=f"tables {(TENANTS, 2, spec_u.storage_width)} uint16, keys "
              f"({r}, {n}), {n_live} distinct, cand ({r}, {m})")

    # ring appends at enqueue_many's and enqueue's shapes
    ring = base_ring.clone()
    fill_t = torch.from_numpy(fill_d).to(dev)
    count_t = torch.from_numpy(count_d).to(dev)
    ms = cuda_ms(lambda: ksk.queue_append_dense(ring, dense_keys, fill_d,
                                                count_d), 50)
    pms = cuda_ms(lambda: ref.queue_append_dense_plain(
        ring, dense_keys, fill_t, count_t), 20)
    jj = torch.arange(BATCH, device=dev)
    dr = torch.arange(TENANTS, device=dev)[:, None].expand(-1, BATCH)
    dc = fill_t[:, None] + jj[None, :]
    dv = signed_view(dense_keys)
    lms = cuda_ms(lambda: signed_view(ring).index_put_((dr, dc), dv), 50)
    report["queue_append_dense"] = dict(
        ms=ms, plain_ms=pms, library_ms=lms, max_abs_err=0.0,
        bytes=TENANTS * BATCH * 8 + 2 * TENANTS * 4, ops=0,
        shape=f"ring ({TENANTS}, {capw}), keys ({TENANTS}, {BATCH})")

    one_keys = dense_keys[:1].contiguous()
    one_rows, one_fill, one_count = (np.array([0]), np.array([0]),
                                     np.array([BATCH]))
    ms = cuda_ms(lambda: ksk.queue_append(ring, one_keys, one_rows, one_fill,
                                          one_count), 50)
    pms = cuda_ms(lambda: ref.queue_append_plain(
        ring, one_keys, torch.zeros(1, dtype=torch.int64, device=dev),
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.full((1,), BATCH, dtype=torch.int64, device=dev)), 20)
    rr = torch.zeros((1, BATCH), dtype=torch.int64, device=dev)
    rc = jj[None, :]
    rv = signed_view(one_keys)
    lms = cuda_ms(lambda: signed_view(ring).index_put_((rr, rc), rv), 50)
    report["queue_append"] = dict(
        ms=ms, plain_ms=pms, library_ms=lms, max_abs_err=0.0,
        bytes=BATCH * 8 + 3 * 4, ops=0,
        shape=f"ring ({TENANTS}, {capw}), keys (1, {BATCH})")

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

    def summary(xs):
        xs = np.sort(np.asarray(xs))
        out = {"n": int(xs.size), "median": float(np.median(xs)),
               "min": float(xs[0]), "max": float(xs[-1])}
        if xs.size >= 200:  # p95 with at least ten samples beyond it
            out["p95"] = float(np.percentile(xs, 95))
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
    profile = profile_epoch(svc, sc.make_epoch(stream_rng, TENANTS, MICRO,
                                               BATCH)[0])
    log(f"one ingest epoch under torch.profiler: wall {profile['wall_ms']:.3f}"
        f" ms, device busy {profile['device_busy_ms']:.3f} ms")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")

    replaces = {
        "fused_query": "src/repro/kernels/sketch.py:298",
        "fused_update_score": "src/repro/kernels/sketch.py:422",
        "queue_append": "src/repro/kernels/sketch.py:526",
        "queue_append_dense": "src/repro/kernels/sketch.py:587",
    }
    sources = {
        "fused_query": "src/repro_torch/kernels/csrc/fused_query.cu",
        "fused_update_score":
            "src/repro_torch/kernels/csrc/fused_update_score.cu",
        "queue_append": "src/repro_torch/kernels/csrc/queue_append.cu",
        "queue_append_dense": "src/repro_torch/kernels/csrc/queue_append.cu",
    }
    kernels = []
    for name in ("fused_query", "fused_update_score", "queue_append",
                 "queue_append_dense"):
        rep = report[name]
        t_bytes = rep["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = rep["ops"] / FP32_OPS_PER_S * 1e3
        log(f"{name} at {rep['shape']}: {rep['ms']:.4f} ms, plain "
            f"{rep['plain_ms']:.4f} ms, library {rep['library_ms']}, bound "
            f"{max(t_bytes, t_ops):.5f} ms ({rep['bytes']} B, {rep['ops']} "
            f"ops)")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": main_launches[name],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": rep["library_ms"]})
    print(json.dumps({"end_to_end": {
        "ingest_events_per_s": rates, "ingest_events_per_s_plain": prates,
        "query_all_ms": qlat, "query_all_ms_plain": pqlat},
        "profile_epoch": profile}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
