"""The CUDA kernels against their plain versions, on the card (small sizes).

Marked `cuda`: these need a GPU and the CUDA toolkit, skip elsewhere, and
run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every kernel must land exactly what its plain PyTorch version lands on
the same device: equal cell states, ring cells and float32 estimates
(the kernels are built with -fmad=false and no fast math, so each float
operation rounds as torch's own CUDA ops do).  `chip_smoke.py` repeats
the comparison at the full-size shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.core.counters import signed_view
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sketch as ksk
from repro_torch.stream import CountService, WindowSpec

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]
# the kernels a tracked service of plain tenants launches
TRACKED_PATH = ("fused_query", "fused_update_score", "queue_append",
                "queue_append_dense")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _spec(name, packed, width=4096):
    return tsk.SketchSpec(width=width, depth=2, counter=getattr(tc, name),
                          packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("name,packed", FORMATS)
def test_update_score_and_query_kernels_equal_plain(cuda, name, packed):
    spec = _spec(name, packed)
    rng = np.random.default_rng(0)
    raw = tc.from_numpy(rng.integers(0, 3000, (3, 3000)).astype(np.uint32),
                        cuda)
    w = torch.ones(raw.shape, dtype=torch.float32, device=cuda)
    skeys, mult = tsk.dedup_weighted(raw, w)
    unif = ops._parity_uniforms([1, 2], raw.shape[1], 4, [3, 0, 1], cuda)
    rows = torch.tensor([3, 0, 1], dtype=torch.int32, device=cuda)
    cand = raw[:, :500].contiguous()
    tk = tc.zeros((4, 2, spec.storage_width), spec.storage_dtype, cuda)
    tp = tk.clone()
    seeds = ops._seeds_tuple(spec)
    _, ek = ksk.fused_update_score(tk, ops.as_device_keys(skeys, cuda), mult,
                                   unif, cand, rows, seeds=seeds,
                                   width=spec.width, counter=spec.counter,
                                   cpl=spec.cells_per_lane)
    _, ep = ref.update_score_rows_ref(tp, skeys, mult, unif, rows, cand,
                                      ops._seed_tensor(spec, cuda),
                                      spec.counter, ksk.CHUNK,
                                      cpl=spec.cells_per_lane)
    assert torch.equal(signed_view(tk), signed_view(tp))
    assert torch.equal(ek, ep)
    probes = raw[0, :700]  # one probe row, broadcast to all 4 tables
    qk = ops.query_many(tk, spec, probes, engine="auto")
    qp = ops.query_many(tk, spec, probes, engine="plain")
    assert torch.equal(qk, qp)


def _random_cells(rng, spec, lead, device):
    """Storage-layout tables (*lead, sw) of random cell states."""
    states = rng.integers(0, min(3000, spec.counter.max_state + 1),
                          lead + (spec.width,))
    return tsk.storage_table(torch.from_numpy(states), spec).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name,packed", FORMATS)
def test_untracked_update_kernels_equal_plain(cuda, name, packed):
    """fused_update (every table) and fused_update_rows (a row map into a
    larger stack, as the window flush's flat leaf) against their plain
    versions: equal cell states, unlisted tables untouched."""
    spec = _spec(name, packed)
    rng = np.random.default_rng(3)
    raw = tc.from_numpy(rng.integers(0, 3000, (3, 2500)).astype(np.uint32),
                        cuda)
    w = torch.ones(raw.shape, dtype=torch.float32, device=cuda)
    w[:, -300:] = 0  # stale ring slots ride along with weight 0
    skeys, mult = tsk.dedup_weighted(raw, w)
    keys = ops.as_device_keys(skeys, cuda)
    unif = ops._parity_uniforms([4, 5], raw.shape[1], 3, [0, 1, 2], cuda)
    seed_t = ops._seed_tensor(spec, cuda)
    kw = dict(seeds=ops._seeds_tuple(spec), width=spec.width,
              counter=spec.counter, cpl=spec.cells_per_lane)
    base = _random_cells(rng, spec, (8, 2), cuda)
    ta, tp = base[:3].clone(), base[:3].clone()
    ksk.fused_update(ta, keys, mult, unif, **kw)
    ref.fused_update_plain(tp, skeys, mult, unif, seed_t, spec.counter,
                           ksk.CHUNK, cpl=spec.cells_per_lane)
    assert torch.equal(signed_view(ta), signed_view(tp))
    rows = [6, 1, 3]
    ta, tp = base.clone(), base.clone()
    ksk.fused_update_rows(ta, keys, mult, unif, rows, **kw)
    ref.fused_update_rows_plain(tp, skeys, mult, unif, torch.tensor(rows),
                                seed_t, spec.counter, ksk.CHUNK,
                                cpl=spec.cells_per_lane)
    assert torch.equal(signed_view(ta), signed_view(tp))
    untouched = [r for r in range(8) if r not in rows]
    assert torch.equal(signed_view(ta)[untouched],
                       signed_view(base)[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("name,packed", FORMATS)
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_window_query_kernels_equal_plain(cuda, name, packed, mode):
    """The three window queries against their plain versions, bit for
    bit, with random weights (gamma-like) and random cell states."""
    spec = _spec(name, packed)
    rng = np.random.default_rng(4)
    t, b = 5, 4
    leaf = _random_cells(rng, spec, (t, b, 2), cuda)
    keys = tc.from_numpy(rng.integers(0, 2**32, (3, 777), dtype=np.uint64)
                         .astype(np.uint32), cuda)
    wts = torch.from_numpy(rng.random((3, b)).astype(np.float32)).to(cuda)
    wts[1, 2] = 0.0  # an expired bucket
    seeds, seed_t = ops._seeds_tuple(spec), ops._seed_tensor(spec, cuda)
    kw = dict(seeds=seeds, width=spec.width, counter=spec.counter, mode=mode,
              cpl=spec.cells_per_lane)
    rows = [4, 0, 2]
    got = ksk.window_query_stacked_rows(leaf, keys, wts, rows, **kw)
    want = ref.window_query_stacked_rows_plain(
        leaf, keys, wts, torch.tensor(rows), seed_t, spec.width,
        spec.counter, mode, spec.cells_per_lane)
    assert torch.equal(got, want)
    rings = signed_view(leaf)[rows].view(leaf.dtype)
    got = ksk.window_query_stacked(rings, keys, wts, **kw)
    assert torch.equal(got, want)
    one = ksk.window_query(rings[1], keys[1].contiguous(),
                           wts[1].contiguous(), **kw)
    assert torch.equal(one, ref.window_query_plain(
        rings[1], keys[1], wts[1], seed_t, spec.width, spec.counter, mode,
        spec.cells_per_lane))
    assert torch.equal(one, want[1])


def _append_case(case, kind, rng, device):
    """(ring, keys, rows, fill, count) of one append edge case: rows None
    for the dense kernel (batch row i -> ring row i)."""
    t, capw, n = 6, 2048, 1024
    if case == "split":  # more rows than one launch carries
        t, capw, n = ksk.MAX_APPEND_ROWS + 37, 256, 128
    if case == "odd_width":  # n % 4 != 0 and a key base off 16 bytes
        n = 1021
    ring = tc.from_numpy(rng.integers(0, 2**32, (t, capw), dtype=np.uint64)
                         .astype(np.uint32), device)
    r = t if kind == "dense" else max(1, t - 2)
    rows = None if kind == "dense" else rng.permutation(t)[:r]
    flat = tc.from_numpy(rng.integers(0, 2**32, r * n + 1, dtype=np.uint64)
                         .astype(np.uint32), device)
    keys = (flat[1:] if case == "odd_width" else flat[:-1]).view(r, n)
    count = rng.integers(1, n + 1, r)
    fill = rng.integers(0, capw - n + 1, r)
    if case == "aligned_fill":
        fill -= fill % 4
    elif case == "odd_fill":
        fill |= 1
    elif case == "zero_count":
        count[::2] = 0
    elif case == "full_row":
        fill = capw - count
    return ring, keys, rows, fill, count


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rows", "dense"])
@pytest.mark.parametrize("case", ["aligned_fill", "odd_fill", "odd_width",
                                  "zero_count", "full_row", "split"])
def test_queue_appends_equal_plain(cuda, case, kind):
    """Both append kernels against their plain versions on the card: the
    16- and 4-byte access paths, ragged and zero counts, rows that end at
    capw, and a call split over launches of MAX_APPEND_ROWS rows."""
    rng = np.random.default_rng(1)
    ring, keys, rows, fill, count = _append_case(case, kind, rng, cuda)
    a, b = ring.clone(), ring.clone()

    def dev(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(cuda)
    ksk.reset_kernel_launches()
    if kind == "dense":
        ksk.queue_append_dense(a, keys, fill, count)
        ref.queue_append_dense_plain(b, keys, dev(fill), dev(count))
    else:
        ksk.queue_append(a, keys, rows, fill, count)
        ref.queue_append_plain(b, keys, dev(rows), dev(fill), dev(count))
    torch.cuda.synchronize()
    assert ksk.kernel_launches()["queue_append" if kind == "rows"
                                 else "queue_append_dense"] == 1
    assert torch.equal(signed_view(a), signed_view(b))
    if case == "zero_count":  # a call with nothing to land launches nothing
        c = a.clone()
        zeros = np.zeros_like(count)
        if kind == "dense":
            ksk.queue_append_dense(c, keys, fill, zeros)
        else:
            ksk.queue_append(c, keys, rows, fill, zeros)
        torch.cuda.synchronize()
        assert torch.equal(signed_view(c), signed_view(a))


@pytest.mark.cuda
def test_enqueue_many_does_not_synchronize(cuda):
    """`enqueue_many` on a tracked and a windowed service issues no
    synchronizing CUDA call: eight microbatches that fill the rings exactly
    and whose event times stay inside one interval (so nothing flushes and
    nothing rotates) run under torch.cuda.set_sync_debug_mode("error").
    The rings then equal those of the plain engine on the same stream."""
    spec = _spec("CMLS16", False)
    wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
    names, wnames = [f"t{i}" for i in range(4)], ["x", "y", "z"]
    rng = np.random.default_rng(6)
    micro = [{n: rng.integers(0, 2**32, 256, dtype=np.uint64)
              .astype(np.uint32) for n in names[:4 - i % 2]}
             for i in range(8)]
    wmicro = [{n: rng.zipf(1.3, 256).astype(np.uint32) for n in wnames}
              for _ in range(8)]
    out = []
    for engine in ("auto", "plain"):
        flat = CountService(spec, tenants=names, queue_capacity=2048,
                            track_top=8, device=cuda, engine=engine)
        win = CountService(queue_capacity=2048, track_top=8, device=cuda,
                           engine=engine)
        for n in wnames:
            win.add_tenant(n, window=wspec)
        before = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        try:
            for i, (ev, wev) in enumerate(zip(micro, wmicro)):
                flat.enqueue_many(ev)
                win.enqueue_many(wev, ts=600.0 + i)
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
        assert flat.stats["flushes"] == win.stats["flushes"] == 0
        assert win.planes[0].ring.fill.tolist() == [2048] * 3
        out.append((flat.planes[0].ring, win.planes[0].ring))
    for ra, rp in zip(*out):
        assert np.array_equal(ra.fill, rp.fill)
        assert torch.equal(signed_view(ra.queue), signed_view(rp.queue))


@pytest.mark.cuda
def test_service_auto_equals_plain_and_launches_every_kernel(cuda):
    spec = _spec("CMLS16", False)
    names = [f"t{i}" for i in range(4)]
    services = []
    ksk.reset_kernel_launches()
    for engine in ("auto", "plain"):
        svc = CountService(spec, tenants=names, queue_capacity=1024,
                           track_top=8, device=cuda, engine=engine)
        rng = np.random.default_rng(2)
        for _ in range(3):
            svc.enqueue_many({n: rng.zipf(1.3, 400).astype(np.uint32) % 999
                              for n in names})
            svc.enqueue("t1", rng.integers(0, 99, 300))
        est = svc.query_all(np.arange(64))
        services.append((svc, est))
        if engine == "auto":
            launches = ksk.kernel_launches()
            assert all(launches[k] > 0 for k in TRACKED_PATH), launches
    (a, ea), (b, eb) = services
    assert torch.equal(signed_view(a.planes[0].tables),
                       signed_view(b.planes[0].tables))
    for n in names:
        assert torch.equal(ea[n], eb[n])


@pytest.mark.cuda
def test_window_and_untracked_services_auto_equal_plain(cuda):
    """A windowed tracked service and an untracked plain one, kernels
    against the plain engine on the card: equal leaves, cursors and
    answers, and the five kernels of these paths launched."""
    wspec = WindowSpec(sketch=_spec("CMLS16", True), buckets=4,
                       interval=60.0)
    out = []
    ksk.reset_kernel_launches()
    for engine in ("auto", "plain"):
        win = CountService(queue_capacity=2048, track_top=8, device=cuda,
                           engine=engine)
        flat = CountService(_spec("CMLS8", False), tenants=["a", "b", "c"],
                            queue_capacity=2048, device=cuda, engine=engine)
        for n in ("x", "y", "z"):
            win.add_tenant(n, window=wspec)
        rng = np.random.default_rng(5)
        ts = 0.0
        for step in range(10):
            ts += float(rng.exponential(50.0))
            win.enqueue_many({n: rng.zipf(1.3, 300).astype(np.uint32) % 999
                              for n in ("x", "y", "z")[:1 + step % 3]},
                             ts=ts)
            flat.enqueue_many({n: rng.zipf(1.3, 700 * (1 + i * (step % 2)))
                               .astype(np.uint32) % 999
                               for i, n in enumerate(("a", "b", "c"))})
            flat.flush()
        res = (win.query_all(np.arange(64)), win.query("y", np.arange(64),
                                                       gamma=0.9),
               win.topk("x", mode="max"), flat.query_all(np.arange(64)))
        out.append((win, flat, res))
    launches = ksk.kernel_launches()
    assert all(launches[k] > 0 for k in (
        "fused_update", "fused_update_rows", "window_query",
        "window_query_stacked", "window_query_stacked_rows")), launches
    (wa, fa, ra), (wp, fp, rp) = out
    assert torch.equal(signed_view(wa.planes[0].tables),
                       signed_view(wp.planes[0].tables))
    assert np.array_equal(wa.planes[0].cursors, wp.planes[0].cursors)
    assert torch.equal(signed_view(fa.planes[0].tables),
                       signed_view(fp.planes[0].tables))
    for n in ra[0]:
        assert torch.equal(ra[0][n], rp[0][n])
    assert torch.equal(ra[1], rp[1])
    assert all(np.array_equal(x, y) for x, y in zip(ra[2], rp[2]))
    for n in ra[3]:
        assert torch.equal(ra[3][n], rp[3][n])
