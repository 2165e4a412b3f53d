"""The CUDA kernels against their plain versions, on the card (small sizes).

Marked `cuda`: these need a GPU and the CUDA toolkit, skip elsewhere, and
run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every kernel must land exactly what its plain PyTorch version lands on
the same device: equal cell states, ring cells and float32 estimates
(the kernels are built with -fmad=false and no fast math, so each float
operation rounds as torch's own CUDA ops do).  `chip_smoke.py` repeats
the comparison at the full-size shapes.  The tiering cases hold the
tier ops to their plain versions, tiered services to untiered ones and
to the plain engine, and the hot-only epoch to no synchronize.  The
model cases (the recommenders, the LM scaffold's five smoke configs,
SASRec / BERT4Rec, DimeNet) have no kernel: they hold the card to the CPU
within stated float32 tolerances; the routed exchange at world size 1 on
NCCL is held to its unrouted forms.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import admission as tadm
from repro_torch.core import counters as tc
from repro_torch.core import prng
from repro_torch.core import sketch as tsk
from repro_torch.core.counters import signed_view
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sketch as ksk
from repro_torch.stream import CountService, TierSpec, WindowSpec
from repro_torch.stream import window as tw

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


def _spec(name, packed, width=4096, depth=2):
    return tsk.SketchSpec(width=width, depth=depth, counter=getattr(tc, name),
                          packed=packed)


# edge cases of the two updates that draw their uniforms in the kernel
# (fused_update_score, fused_update)
DRAW_CASES = ("random", "all_distinct", "one_key", "empty_lead", "short",
              "ragged", "one_row", "deep", "ragged_cand", "hi_word")


def _drawn_case(case, rng, device):
    """(depth, table count, rows, raw keys (R, N), weights, cand (R, M),
    grid) of one drawn update.  "all_distinct": 2 rows of 65,536 distinct
    keys, 64 chunks past the kernel's compaction plan; "one_key": every
    event one key; "empty_lead": the first 5 chunks of each sorted row
    dead (a hot key of weight 0); "short": N < CHUNK; "ragged": N not a
    multiple of CHUNK; "deep": depth 4 (the kernel's instance for depths
    3-8); "ragged_cand": M not a multiple of the score tile; "hi_word": a
    decoupled (70,000, N) grid at rows >= 65,537 with N = 65,536, whose
    flat draw index needs the counter's high word."""
    t, r, n, m, depth, grid = 4, 3, 3000, 500, 2, None
    if case == "all_distinct":
        r, n = 2, 64 * ksk.CHUNK
    elif case == "one_row":
        r = 1
    elif case == "short":
        n = 700
    elif case == "ragged":
        n = 3 * ksk.CHUNK + 333
    elif case == "deep":
        depth, n = 4, 5000
    elif case == "ragged_cand":
        m = 2 * 1024 + 77
    elif case == "empty_lead":
        n = 8 * ksk.CHUNK
    elif case == "hi_word":
        n, grid = 64 * ksk.CHUNK, (70_000, np.asarray([65_537, 69_999, 3]))
    rows = rng.permutation(t)[:r]
    raw = (rng.zipf(1.3, (r, n)) % 20_000).astype(np.uint32)
    w = np.ones((r, n), np.float32)
    w[:, -200:] = 0  # stale ring slots ride along with weight 0
    if case == "all_distinct":
        raw = _distinct_keys(r * n).reshape(r, n)
    elif case == "one_key":
        raw[:] = 77
    elif case == "empty_lead":
        raw[:, :5 * ksk.CHUNK + 100] = 1  # key 1 sorts first
        w[:, :5 * ksk.CHUNK + 100] = 0
    cand = np.concatenate([raw[:, :m - 8], np.asarray(
        [[0, 0xFFFFFFFF, 1, 77, 5, 6, 7, 8]] * r, np.uint32)], axis=1)
    return depth, t, rows, raw, w, cand, grid


def _drawn_plain_uniforms(key, grid, n_tables, rows, n, device):
    total, urows = (n_tables, rows) if grid is None else grid
    return prng.uniform_rows(key, total, n, urows, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DRAW_CASES)
@pytest.mark.parametrize("name,packed", FORMATS)
def test_update_score_and_query_kernels_equal_plain(cuda, name, packed,
                                                    case):
    """fused_update_score, uniforms drawn in the kernel, against its plain
    version fed `prng.uniform_rows` of the same key and grid: equal cell
    states and estimates (which proves the draw bit for bit), unlisted
    tables untouched, at the edge cases of DRAW_CASES; then the fused
    query on the updated tables."""
    rng = np.random.default_rng(0)
    depth, t, rows, raw, w, cand, grid = _drawn_case(case, rng, cuda)
    spec = _spec(name, packed, depth=depth)
    skeys, mult = tsk.dedup_weighted(tc.from_numpy(raw, cuda),
                                     torch.from_numpy(w).to(cuda))
    key = np.asarray([1, 2], np.uint32)
    cand = tc.from_numpy(cand, cuda)
    base = _random_cells(rng, spec, (t, depth), cuda)
    tk, tp = base.clone(), base.clone()
    ksk.reset_kernel_launches()
    _, ek = ksk.fused_update_score(tk, ops.as_device_keys(skeys, cuda), mult,
                                   key, cand, rows, grid=grid,
                                   seeds=ops._seeds_tuple(spec),
                                   width=spec.width, counter=spec.counter,
                                   cpl=spec.cells_per_lane)
    unif = _drawn_plain_uniforms(key, grid, t, rows, raw.shape[1], cuda)
    _, ep = ref.update_score_rows_ref(tp, skeys, mult, unif,
                                      torch.from_numpy(rows).to(cuda), cand,
                                      ops._seed_tensor(spec, cuda),
                                      spec.counter, ksk.CHUNK,
                                      cpl=spec.cells_per_lane)
    torch.cuda.synchronize()
    assert ksk.kernel_launches()["fused_update_score"] == 1
    assert torch.equal(signed_view(tk), signed_view(tp))
    assert torch.equal(ek, ep)
    untouched = [i for i in range(t) if i not in rows]
    assert torch.equal(signed_view(tk)[untouched],
                       signed_view(base)[untouched])
    probes = tc.from_numpy(raw[0, :700].copy(), cuda)  # broadcast to all
    qk = ops.query_many(tk, spec, probes, engine="auto")
    qp = ops.query_many(tk, spec, probes, engine="plain")
    assert torch.equal(qk, qp)


def _random_cells(rng, spec, lead, device):
    """Storage-layout tables (*lead, sw) of random cell states."""
    states = rng.integers(0, min(3000, spec.counter.max_state + 1),
                          lead + (spec.width,))
    return tsk.storage_table(torch.from_numpy(states), spec).to(device)


# edge cases of the two row-mapped kernels (fused_update_rows,
# window_query_stacked_rows), beside the random inputs of the first port
UPDATE_CASES = ("random", "split", "one_row", "all_distinct", "one_key",
                "extreme_keys", "mult_zero", "high_states", "many_live",
                "deep")
WINDOW_CASES = ("random", "split", "one_row", "one_key", "all_distinct",
                "extreme_keys", "passes")


def _distinct_keys(n: int) -> np.ndarray:
    """n distinct uint32 keys spread over the whole range (an odd
    multiplier is a bijection mod 2^32)."""
    return np.arange(n, dtype=np.uint32) * np.uint32(2654435761)


def _update_rows_case(case, spec, rng, device):
    """(tables, rows, raw keys (R, N), weights, uniforms) of one
    row-mapped update: rows a unique map into a larger stack of random
    cell states; "split" maps MAX_MAPPED_ROWS + 37 rows (two launches),
    "high_states" starts every cell within 9 states of the maximum
    (CMLS8: states 246-255) with u = 0 and n in {450, 1489, 1923, 10000},
    where the log counter's nfold steps one state past the reference
    property test's bound; "many_live" gives each row over 9,000 live
    keys, more than the kernel compacts before its chunk loop (each
    chunk's threads then take their own slots); "deep" is a depth-4
    sketch (the kernel's instance for depths 3-8) with rows of 34
    chunks."""
    t, r, n = 8, 3, 2500
    if case == "split":
        t, r, n = ksk.MAX_MAPPED_ROWS + 40, ksk.MAX_MAPPED_ROWS + 37, 1100
    elif case == "one_row":
        r = 1
    elif case == "many_live":
        r, n = 2, 9300
    elif case == "deep":
        r, n = 2, 33 * ksk.CHUNK + 100
    if case == "high_states":
        top = spec.counter.max_state
        states = rng.integers(top - 9, top + 1, (t, spec.depth, spec.width))
        tables = tsk.storage_table(torch.from_numpy(states), spec).to(device)
    else:
        tables = _random_cells(rng, spec, (t, spec.depth), device)
    rows = rng.permutation(t)[:r]
    raw = rng.integers(0, 3000, (r, n)).astype(np.uint32)
    if case in ("all_distinct", "many_live"):
        raw = _distinct_keys(r * n).reshape(r, n)
    elif case == "one_key":
        raw[:] = 77
    elif case == "extreme_keys":
        raw = rng.choice(np.array([0, 0xFFFFFFFF, 1, 0xFFFFFFFE], np.uint32),
                         (r, n))
    w = np.ones((r, n), np.float32)
    w[:, -300:] = 0  # stale ring slots ride along with weight 0
    if case == "mult_zero":
        w[:] = 0
    elif case == "high_states":
        w = rng.choice(np.array([450, 1489, 1923, 10000, 1], np.float32),
                       (r, n))
    unif = ops._parity_uniforms([4, 5], n, t, rows, device)
    if case == "high_states":
        unif = torch.zeros_like(unif)
    return (tables, rows, tc.from_numpy(raw, device),
            torch.from_numpy(w).to(device), unif)


# fused_update (the dense update, uniforms drawn in the kernel) at the
# edge cases of the drawn updates (its rows are every table, so
# "ragged_cand" has nothing to add)
DENSE_CASES = tuple("dense_" + c for c in DRAW_CASES if c != "ragged_cand")


@pytest.mark.cuda
@pytest.mark.parametrize("case", UPDATE_CASES + DENSE_CASES)
@pytest.mark.parametrize("name,packed", FORMATS)
def test_untracked_update_kernels_equal_plain(cuda, name, packed, case):
    """fused_update (every table; its uniforms drawn in the kernel, the
    plain version fed `prng.uniform_rows` of the same key and grid) and
    fused_update_rows (a row map into a larger stack, as the window
    flush's flat leaf) against their plain versions: equal cell states,
    unlisted tables untouched; fused_update_rows also at the edge cases
    of UPDATE_CASES, fused_update at those of DENSE_CASES."""
    spec = _spec(name, packed,
                 depth=4 if case in ("deep", "dense_deep") else 2)
    rng = np.random.default_rng(3)
    seed_t = ops._seed_tensor(spec, cuda)
    kw = dict(seeds=ops._seeds_tuple(spec), width=spec.width,
              counter=spec.counter, cpl=spec.cells_per_lane)
    if case.startswith("dense_"):
        _, _, _, raw, w, _, grid = _drawn_case(case[len("dense_"):], rng,
                                               cuda)
        r, n = raw.shape
        skeys, mult = tsk.dedup_weighted(tc.from_numpy(raw, cuda),
                                         torch.from_numpy(w).to(cuda))
        key = np.asarray([4, 5], np.uint32)
        base = _random_cells(rng, spec, (r, spec.depth), cuda)
        ta, tp = base.clone(), base.clone()
        ksk.reset_kernel_launches()
        ksk.fused_update(ta, ops.as_device_keys(skeys, cuda), mult, key,
                         grid=grid, **kw)
        unif = _drawn_plain_uniforms(key, grid, r, np.arange(r), n, cuda)
        ref.fused_update_plain(tp, skeys, mult, unif, seed_t, spec.counter,
                               ksk.CHUNK, cpl=spec.cells_per_lane)
        torch.cuda.synchronize()
        assert ksk.kernel_launches()["fused_update"] == 1
        assert torch.equal(signed_view(ta), signed_view(tp))
        return
    if case != "random":
        base, rows, raw, w, unif = _update_rows_case(case, spec, rng, cuda)
        skeys, mult = tsk.dedup_weighted(raw, w)
        ta, tp = base.clone(), base.clone()
        ksk.reset_kernel_launches()
        ksk.fused_update_rows(ta, ops.as_device_keys(skeys, cuda), mult,
                              unif, rows, **kw)
        ref.fused_update_rows_plain(tp, skeys, mult, unif,
                                    torch.from_numpy(rows), seed_t,
                                    spec.counter, ksk.CHUNK,
                                    cpl=spec.cells_per_lane)
        torch.cuda.synchronize()
        assert ksk.kernel_launches()["fused_update_rows"] == 1
        assert torch.equal(signed_view(ta), signed_view(tp))
        if case == "mult_zero":
            assert torch.equal(signed_view(ta), signed_view(base))
        return
    raw = tc.from_numpy(rng.integers(0, 3000, (3, 2500)).astype(np.uint32),
                        cuda)
    w = torch.ones(raw.shape, dtype=torch.float32, device=cuda)
    w[:, -300:] = 0  # stale ring slots ride along with weight 0
    skeys, mult = tsk.dedup_weighted(raw, w)
    keys = ops.as_device_keys(skeys, cuda)
    unif = ops._parity_uniforms([4, 5], raw.shape[1], 3, [0, 1, 2], cuda)
    base = _random_cells(rng, spec, (8, 2), cuda)
    ta, tp = base[:3].clone(), base[:3].clone()
    ksk.fused_update(ta, keys, mult, [4, 5], **kw)
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


def _window_rows_case(case, rng, t):
    """(rows, keys (R, N) numpy) of one row-mapped window read of a
    t-ring leaf: "split" reads MAX_MAPPED_ROWS + 37 rings (repeats
    allowed: a read), "all_distinct" a ring's 16,448 candidates all
    distinct, "passes" 300,000 distinct candidates a ring (every 97th the
    key 0xFFFFFFFF) on the 8 x 2 instance, over 1,000 blocks a ring."""
    rows, n = [4, 0, 2], 777
    if case == "split":
        rows, n = rng.integers(0, t, ksk.MAX_MAPPED_ROWS + 37), 64
    elif case == "one_row":
        rows = [3]
    elif case == "all_distinct":
        n = 16_448
    elif case == "passes":
        rows, n = [1, 3], 300_000
    r = len(rows)
    keys = rng.integers(0, 3000, (r, n)).astype(np.uint32)
    if case in ("all_distinct", "passes"):
        keys = _distinct_keys(r * n).reshape(r, n)
        if case == "passes":
            keys[:, ::97] = 0xFFFFFFFF
    elif case == "one_key":
        keys[:] = 12345
    elif case == "extreme_keys":
        keys = rng.choice(np.array([0, 0xFFFFFFFF, 1, 0xFFFFFFFE],
                                   np.uint32), (r, n))
    return np.asarray(rows), keys


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES)
@pytest.mark.parametrize("name,packed", FORMATS)
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_window_query_kernels_equal_plain(cuda, name, packed, mode, case):
    """The three window queries against their plain versions, bit for
    bit, with random weights (gamma-like) and random cell states; the
    row-mapped one also at the edge cases of WINDOW_CASES, on an 8-bucket
    leaf (the kernel's instance for the windowed path's 8 x 2 geometry;
    the random case's 4 buckets take its general instance)."""
    spec = _spec(name, packed)
    rng = np.random.default_rng(4)
    if case != "random":
        t, b = 5, 8
        leaf = _random_cells(rng, spec, (t, b, 2), cuda)
        rows, keys = _window_rows_case(case, rng, t)
        wts = torch.from_numpy(rng.random((len(rows), b)).astype(
            np.float32)).to(cuda)
        wts[0, 5] = 0.0  # an expired bucket
        keys = tc.from_numpy(keys, cuda)
        ksk.reset_kernel_launches()
        got = ksk.window_query_stacked_rows(
            leaf, keys, wts, rows, seeds=ops._seeds_tuple(spec),
            width=spec.width, counter=spec.counter, mode=mode,
            cpl=spec.cells_per_lane)
        want = ref.window_query_stacked_rows_plain(
            leaf, keys, wts, torch.from_numpy(rows),
            ops._seed_tensor(spec, cuda), spec.width, spec.counter, mode,
            spec.cells_per_lane)
        torch.cuda.synchronize()
        assert ksk.kernel_launches()["window_query_stacked_rows"] == 1
        assert torch.equal(got, want)
        return
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


# edge cases of kernels 7 and 8 (window_query, window_query_stacked): one
# lane a (key, bucket), buckets of weight 0 not read, keys with a ring
# stride (0: one row shared by every ring)
LANE_CASES = ("random", "bucket0_zero", "all_zero", "n_buckets",
              "stride0", "one_key_n", "ragged", "passes", "extreme_keys",
              "repeated")


def _lane_case(case, rng, r):
    """(keys (r, N) or (N,) numpy, weight sets [(label, (r, B) numpy)]) of
    one window read of r rings of 8 buckets."""
    n = 777
    if case == "one_key_n":  # N = 1
        n = 1
    elif case == "ragged":  # N not a multiple of any block's keys
        n = 4096 + 33
    elif case == "passes":  # 300,000 keys a ring: 9,375 blocks a ring
        n = 300_000
    keys = rng.integers(0, 2**32, (r, n), dtype=np.uint64).astype(np.uint32)
    if case == "passes":
        keys = _distinct_keys(r * n).reshape(r, n)
        keys[:, ::97] = 0xFFFFFFFF
    elif case == "extreme_keys":
        keys = rng.choice(np.array([0, 0xFFFFFFFF, 1, 0xFFFFFFFE],
                                   np.uint32), (r, n))
    elif case == "repeated":
        keys = rng.integers(0, 5, (r, n)).astype(np.uint32)
    elif case == "stride0":
        keys = keys[0]
    full = rng.random((r, 8)).astype(np.float32)
    if case == "bucket0_zero":
        full[:, 0] = 0.0
        full[1, 3] = 0.0
    elif case == "all_zero":
        full[:] = 0.0
    sets = [("weights", full)]
    if case == "n_buckets":  # window_weights_stacked's masks, k = 1..8
        cursors = np.arange(r) % 8
        sets = [(f"n_buckets={k}",
                 tw.window_weights_stacked(cursors, 8, k).numpy())
                for k in range(1, 9)]
    return keys, sets


@pytest.mark.cuda
@pytest.mark.parametrize("case", LANE_CASES)
@pytest.mark.parametrize("name,packed", FORMATS)
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_window_lane_kernels_equal_plain(cuda, name, packed, mode, case):
    """Kernels 7 and 8 against their plain versions, bit for bit, on
    rings of 8 x 2 (the template instance) at the edge cases of
    LANE_CASES: a zero weight at bucket 0, every weight zero, the
    n_buckets masks 1..8, (N,) keys shared by every ring (ring stride 0),
    N = 1, N not a multiple of the tile,
    300,000 keys a ring, keys 0 and 0xFFFFFFFF, repeated keys; one
    launch a call."""
    spec = _spec(name, packed)
    rng = np.random.default_rng(9)
    r = 5
    rings = _random_cells(rng, spec, (r, 8, 2), cuda)
    keys_np, sets = _lane_case(case, rng, r)
    keys = tc.from_numpy(keys_np, cuda)
    seed_t = ops._seed_tensor(spec, cuda)
    kw = dict(width=spec.width, counter=spec.counter, mode=mode,
              cpl=spec.cells_per_lane)
    plain_keys = keys if keys.dim() == 2 else keys.expand(r, -1)
    for label, wts_np in sets:
        wts = torch.from_numpy(wts_np).to(cuda)
        ksk.reset_kernel_launches()
        got = ksk.window_query_stacked(rings, keys, wts,
                                       seeds=ops._seeds_tuple(spec), **kw)
        one = ksk.window_query(rings[2], plain_keys[2].contiguous(),
                               wts[2].contiguous(),
                               seeds=ops._seeds_tuple(spec), **kw)
        want = ref.window_query_stacked_plain(rings, plain_keys, wts, seed_t,
                                              **kw)
        torch.cuda.synchronize()
        launches = ksk.kernel_launches()
        assert launches["window_query_stacked"] == 1, label
        assert launches["window_query"] == 1, label
        assert torch.equal(got, want), label
        assert torch.equal(one, want[2]), label
        if case == "all_zero":
            assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("buckets,depth", [(4, 3), (1, 2), (3, 8),
                                           (33, 1)])
@pytest.mark.parametrize("name,packed", FORMATS)
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_window_lane_kernels_general_instance(cuda, name, packed, mode,
                                              buckets, depth):
    """The general instance of kernels 7 and 8 (any B, any depth up to
    8; B = 33 reduces in two rounds of 32 buckets) against the plain
    versions, per-ring and shared keys, with zero weights."""
    spec = _spec(name, packed, depth=depth)
    rng = np.random.default_rng(10)
    r = 3
    rings = _random_cells(rng, spec, (r, buckets, depth), cuda)
    keys = tc.from_numpy(rng.integers(0, 2**32, (r, 1000), dtype=np.uint64)
                         .astype(np.uint32), cuda)
    wts_np = rng.random((r, buckets)).astype(np.float32)
    wts_np[0, 0] = 0.0
    wts_np[2, buckets // 2:] = 0.0
    wts = torch.from_numpy(wts_np).to(cuda)
    seeds, seed_t = ops._seeds_tuple(spec), ops._seed_tensor(spec, cuda)
    kw = dict(width=spec.width, counter=spec.counter, mode=mode,
              cpl=spec.cells_per_lane)
    for probes in (keys, keys[1]):
        plain_keys = probes if probes.dim() == 2 else probes.expand(r, -1)
        got = ksk.window_query_stacked(rings, probes, wts, seeds=seeds, **kw)
        want = ref.window_query_stacked_plain(rings, plain_keys, wts, seed_t,
                                              **kw)
        assert torch.equal(got, want)
    one = ksk.window_query(rings[0], keys[0], wts[0], seeds=seeds, **kw)
    assert torch.equal(one, ref.window_query_plain(
        rings[0], keys[0], wts[0], seed_t, **kw))


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
def test_flush_does_not_synchronize(cuda):
    """The flush path issues no synchronizing CUDA call: a tracked flush,
    window flushes of one and of two fill classes, and a windowed
    `enqueue_many(..., ts=)` that flushes and rotates run under
    torch.cuda.set_sync_debug_mode("error").  Tables, leaves, cursors,
    watermarks, rings, fills and trackers then equal the plain engine's
    on the same stream."""
    spec = _spec("CMLS16", False)
    wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
    names, wnames = [f"t{i}" for i in range(4)], ["x", "y", "z"]
    rng = np.random.default_rng(7)

    def zipf(n):
        return rng.zipf(1.3, n).astype(np.uint32) % 5000
    flat_ev = {n: zipf(900) for n in names}
    win_evs = [({n: zipf(700) for n in wnames}, 600.0),        # one class
               ({"x": zipf(300), "y": zipf(1500)}, 610.0),      # two
               ({"z": zipf(500)}, 620.0),                       # pending,
               ({"x": zipf(400), "z": zipf(200)}, 745.0)]       # then rotate
    first = {n: zipf(10) for n in wnames}  # sets the watermarks
    out = []
    for engine in ("auto", "plain"):
        flat = CountService(spec, tenants=names, queue_capacity=4096,
                            track_top=8, device=cuda, engine=engine)
        win = CountService(queue_capacity=4096, track_top=8, device=cuda,
                           engine=engine)
        for n in wnames:
            win.add_tenant(n, window=wspec)
        win.enqueue_many(first, ts=590.0)
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        try:
            flat.enqueue_many(flat_ev)
            flat.flush()
            for i, (ev, ts) in enumerate(win_evs):
                win.enqueue_many(ev, ts=ts)
                if i < 2:
                    win.flush()
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
        assert win.planes[0].cursors.tolist() == [3, 1, 3]
        out.append((flat, win))
    for a, b in zip(*out):
        _, ta = convert.service_to_numpy(a)
        _, tb = convert.service_to_numpy(b)
        for kind in ("planes", "windows"):
            for la, lb in zip(ta[kind], tb[kind]):
                for key, va in la.items():
                    if isinstance(va, dict):
                        for sub, x in va.items():
                            assert np.array_equal(x, lb[key][sub]), (key, sub)
                    else:
                        assert np.array_equal(va, lb[key]), key


@pytest.mark.cuda
def test_windowed_reads_do_not_synchronize(cuda):
    """A windowed service's reads issue no synchronizing CUDA call:
    `query` (full window, n_buckets, gamma, max) and `query_all` (shared
    and per-tenant probes) run under torch.cuda.set_sync_debug_mode
    ("error") after rotations.  Each answer equals the plain engine's on
    the same stream."""
    spec = _spec("CMLS16", False)
    wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
    names = ["x", "y", "z"]
    rng = np.random.default_rng(8)
    stream = [({n: (rng.zipf(1.3, 500) % 3000).astype(np.uint32)
                for n in names}, ts) for ts in (10.0, 75.0, 200.0)]
    probes = rng.integers(0, 3000, (4, 300)).astype(np.uint32)
    reads = [lambda s: s.query("y", probes[2]),
             lambda s: s.query("y", probes[2], n_buckets=2),
             lambda s: s.query("y", probes[2], gamma=0.9),
             lambda s: s.query("y", probes[2], mode="max"),
             lambda s: s.query_all(probes[0]),
             lambda s: s.query_all(probes)]
    out = []
    for engine in ("auto", "plain"):
        svc = CountService(queue_capacity=4096, track_top=8, device=cuda,
                           engine=engine)
        svc.add_tenant("m", spec=_spec("CMS32", False))
        for n in names:
            svc.add_tenant(n, window=wspec)
        for events, ts in stream:
            svc.enqueue_many(events, ts=ts)
            svc.flush()
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = [read(svc) for read in reads]
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
        out.append(got)
    for a, b in zip(*out):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for n in a:
                assert torch.equal(a[n], b[n]), n
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_tracked_and_untracked_flushes_draw_no_uniform_tensor(cuda,
                                                              monkeypatch):
    """On the card the tracked flush (fused_update_score) and the
    untracked all-active flush (fused_update) draw their uniforms inside
    the kernels: with `prng.uniform_rows` made to raise, both flush, and
    their tables equal those of the plain engine (run after, with the
    draw restored) on the same stream."""
    spec = _spec("CMLS16", False)
    names = [f"t{i}" for i in range(4)]
    rng = np.random.default_rng(8)
    epochs = [{n: rng.zipf(1.3, 900).astype(np.uint32) % 5000
               for n in names} for _ in range(2)]

    def drive(engine):
        tracked = CountService(spec, tenants=names, queue_capacity=2048,
                               track_top=8, device=cuda, engine=engine)
        flat = CountService(spec, tenants=names, queue_capacity=2048,
                            device=cuda, engine=engine)
        for events in epochs:
            for svc in (tracked, flat):
                svc.enqueue_many(events)
                svc.flush()
        torch.cuda.synchronize()
        return tracked, flat

    def refuse(*args, **kw):
        raise AssertionError("a uniform tensor was drawn")

    with monkeypatch.context() as mp:
        mp.setattr(prng, "uniform_rows", refuse)
        ksk.reset_kernel_launches()
        auto = drive("auto")
        launches = ksk.kernel_launches()
    assert launches["fused_update_score"] == 2
    assert launches["fused_update"] == 2
    plain = drive("plain")
    for a, p in zip(auto, plain):
        assert a.stats["flushes"] == p.stats["flushes"] == 2
        assert torch.equal(signed_view(a.planes[0].tables),
                           signed_view(p.planes[0].tables))
    assert np.array_equal(auto[0].planes[0].tracker.keys.cpu().numpy(),
                          plain[0].planes[0].tracker.keys.cpu().numpy())


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


# --------------------------------------------------------------------------
# admission and snapshots on the card
# --------------------------------------------------------------------------

ASPEC = tadm.AdmissionSpec(threshold=6.0, n_fallback=64, table_rows=4096)


def _admission_services(device, engine, name="CMLS16"):
    """A tracked plane and a windowed plane of `name` counters, every
    tenant with ASPEC, driven through three epochs that rotate the rings;
    events of the last epoch left pending."""
    spec = _spec(name, False)
    wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
    svc = CountService(spec, queue_capacity=4096, track_top=8, device=device,
                       engine=engine)
    names, wnames = [f"t{i}" for i in range(4)], ["x", "y", "z"]
    for n in names:
        svc.add_tenant(n, admission=ASPEC)
    svc.add_tenant("m", spec=_spec("CMS32", False))
    for n in wnames:
        svc.add_tenant(n, window=wspec, admission=ASPEC)
    rng = np.random.default_rng(9)
    for ts in (10.0, 75.0, 200.0):
        svc.enqueue_many({n: (rng.zipf(1.3, 700) % 3000).astype(np.uint32)
                          for n in names + ["m"]})
        svc.enqueue_many({n: (rng.zipf(1.3, 500) % 3000).astype(np.uint32)
                          for n in wnames}, ts=ts)
    return svc, names, wnames


ADMIT_IDS = np.concatenate([np.arange(200), [0xFFFF_FFFF]]).astype(np.uint32)
ADMITS = [("t0", {}), ("t3", {}), ("x", {}), ("y", {"n_buckets": 2}),
          ("z", {"gamma": 0.8}), ("x", {"mode": "max"})]


@pytest.mark.cuda
def test_admit_tracked_and_windowed_equal_plain(cuda):
    """`admit` on the kernels equals the plain engine on the card: the
    tracked admit's flush (kernel 2), the windowed admit's flush (kernel
    6) and re-score (kernel 9), n_buckets / gamma / max included."""
    out = []
    for engine in ("auto", "plain"):
        svc, _, _ = _admission_services(cuda, engine)
        ksk.reset_kernel_launches()
        got = [svc.admit(n, ADMIT_IDS, **kw) for n, kw in ADMITS]
        torch.cuda.synchronize()
        if engine == "auto":
            launches = ksk.kernel_launches()
            for k in ("fused_update_score", "fused_update_rows",
                      "window_query_stacked_rows"):
                assert launches[k] > 0, launches
        out.append((svc, got))
    (a, ga), (b, gb) = out
    for (ra, ma), (rb, mb) in zip(ga, gb):
        assert ra.device.type == cuda.type and ra.dtype == torch.int32
        assert torch.equal(ra, rb) and torch.equal(ma, mb)
    assert any(bool(m.any()) for _, m in ga)
    for pa, pb in zip(a.planes, b.planes):
        assert torch.equal(pa.tracker.estimates, pb.tracker.estimates)
        assert torch.equal(signed_view(pa.tracker.keys),
                           signed_view(pb.tracker.keys))


@pytest.mark.cuda
def test_observe_and_admit_kernel_equals_xla(cuda):
    spec = _spec("CMLS16", False, width=4096, depth=3)
    ids = np.random.default_rng(2).integers(0, 8000, 12000).astype(np.uint32)
    assert len(np.unique(ids)) > 1024  # several update chunks
    key = np.asarray([0, 4], np.uint32)
    out = {}
    for engine in ("kernel", "xla", "auto"):
        ksk.reset_kernel_launches()
        s, rows, mask = tadm.observe_and_admit(tsk.init(spec, cuda), ids, key,
                                               ASPEC, engine=engine)
        torch.cuda.synchronize()
        launches = ksk.kernel_launches()
        on_kernels = launches["fused_update"] == launches["fused_query"] == 1
        assert on_kernels == (engine != "xla"), (engine, launches)
        out[engine] = (s.table, rows, mask)
    for engine in ("xla", "auto"):
        assert torch.equal(signed_view(out["kernel"][0]),
                           signed_view(out[engine][0]))
        assert torch.equal(out["kernel"][1], out[engine][1])
        assert torch.equal(out["kernel"][2], out[engine][2])
    assert bool(out["kernel"][2].any())
    with pytest.raises(ValueError, match="CUDA"):
        tadm.observe_and_admit(tsk.init(spec, "cpu"), ids, key, ASPEC,
                               engine="kernel")


@pytest.mark.cuda
def test_observe_and_admit_auto_runs_kernels_past_one_shot_size(cuda):
    """A 16 MiB table, past `ops.ONE_SHOT_UPDATE_TABLE_BYTES`: "auto"
    still launches the update and query kernels and equals "xla"."""
    spec = _spec("CMS32", False, width=1 << 21, depth=2)
    assert spec.memory_bytes > ops.ONE_SHOT_UPDATE_TABLE_BYTES
    ids = (np.random.default_rng(5).zipf(1.3, 12000) % 8000).astype(
        np.uint32)
    key = np.asarray([0, 6], np.uint32)
    out = {}
    for engine in ("auto", "xla"):
        ksk.reset_kernel_launches()
        out[engine] = tadm.observe_and_admit(tsk.init(spec, cuda), ids, key,
                                             ASPEC, engine=engine)
        torch.cuda.synchronize()
        launches = ksk.kernel_launches()
        on_kernels = launches["fused_update"] == launches["fused_query"] == 1
        assert on_kernels == (engine == "auto"), (engine, launches)
    (sa, ra, ma), (sx, rx, mx) = out["auto"], out["xla"]
    assert torch.equal(signed_view(sa.table), signed_view(sx.table))
    assert torch.equal(ra, rx) and torch.equal(ma, mx)
    assert bool(ma.any())


@pytest.mark.cuda
def test_admit_on_a_clean_plane_does_not_synchronize(cuda):
    """`admit` on clean tracked and windowed planes runs under
    torch.cuda.set_sync_debug_mode("error"), equal to the plain engine."""
    out = []
    for engine in ("auto", "plain"):
        svc, _, _ = _admission_services(cuda, engine)
        svc.flush()
        on_card = tc.from_numpy(ADMIT_IDS, cuda)  # ids already on the card
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = [svc.admit(n, ADMIT_IDS, **kw) for n, kw in ADMITS]
            got += [svc.admit("t1", on_card), svc.admit("y", on_card)]
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
        out.append(got)
    for (ra, ma), (rb, mb) in zip(*out):
        assert torch.equal(ra, rb) and torch.equal(ma, mb)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["CMS32", "CMLS16"])
def test_snapshot_on_the_card_restores_on_the_card_and_the_cpu(cuda,
                                                                tmp_path,
                                                                name):
    """A snapshot taken on the card (pending events included) restores on
    the card, on the card re-packed, and on the CPU: every leaf equal,
    then equal answers (`query_all`, `admit`, `topk`) after the restored
    services flush the pending events, the CPU restore's too: the kernels
    and the plain versions compute one float32 graph on both devices."""
    svc, names, wnames = _admission_services(cuda, "auto", name)
    svc.snapshot(str(tmp_path), step=1)
    on_card = CountService.restore(str(tmp_path), device=cuda)
    on_cpu = CountService.restore(str(tmp_path), device="cpu")
    packed = CountService.restore(str(tmp_path), device=cuda, packed=True)
    _, tree = convert.service_to_numpy(svc)
    for other in (on_card, on_cpu, packed):
        assert other.admission_of("x") == ASPEC
    for other in (on_card, on_cpu):
        _, t2 = convert.service_to_numpy(other)
        for kind in ("planes", "windows"):
            for la, lb in zip(tree[kind], t2[kind]):
                for key, va in la.items():
                    if isinstance(va, dict):
                        for sub, x in va.items():
                            assert np.array_equal(x, lb[key][sub]), (key, sub)
                    else:
                        assert np.array_equal(va, lb[key]), key
    others = (on_card, packed, on_cpu)
    probes = np.arange(300, dtype=np.uint32)
    want = svc.query_all(probes)
    for other in others:
        got = other.query_all(probes)
        for n in want:
            assert np.array_equal(want[n].cpu().numpy(), got[n].cpu().numpy())
    for n, kw in ADMITS:
        ra, ma = svc.admit(n, ADMIT_IDS, **kw)
        for other in others:
            rb, mb = other.admit(n, ADMIT_IDS, **kw)
            assert np.array_equal(ra.cpu().numpy(), rb.cpu().numpy())
            assert np.array_equal(ma.cpu().numpy(), mb.cpu().numpy())
    for n in names + wnames:
        ka, ea = svc.topk(n)
        for other in others:
            kb, eb = other.topk(n)
            assert np.array_equal(ka, kb) and np.array_equal(ea, eb)


# --------------------------------------------------------------------------
# hot/cold tiering on the card
# --------------------------------------------------------------------------

def _spill_case(spec, rng, device):
    """A cold stack of 3 tenants whose grid rows (7, 2, 5) of a (9, N)
    grid are not arange(3), ragged live fills, and 70 candidates a row."""
    cells = _random_cells(rng, spec, (3, spec.depth), device)
    n = 3 * ksk.CHUNK + 200
    keys = torch.from_numpy((rng.zipf(1.3, (3, n)) % 900).astype(np.int64))
    keys = tc.from_i64(keys, torch.uint32).to(device)
    fill = torch.tensor([[n], [1500], [40]], device=device)
    weights = (torch.arange(n, device=device)[None, :] < fill).to(
        torch.float32)
    cand = tc.from_i64(torch.from_numpy((rng.zipf(1.3, (3, 70)) % 900)
                                        .astype(np.int64)),
                       torch.uint32).to(device)
    return cells, keys, weights, cand, (9, np.array([7, 2, 5]))


@pytest.mark.cuda
@pytest.mark.parametrize("scored", [True, False], ids=["cand", "no_cand"])
@pytest.mark.parametrize("name,packed", FORMATS)
def test_tier_spill_equals_plain_and_runs_kernel_2_or_5(cuda, name, packed,
                                                        scored):
    """`ops.tier_spill` on the card: kernel 2 (with candidates) or kernel
    5 on the uploaded stack, drawing at grid rows that are not arange(C);
    equal to its plain version on the card, tallied as tier_spill only."""
    spec = _spec(name, packed)
    rng = np.random.default_rng(31)
    cells, keys, weights, cand, grid = _spill_case(spec, rng, cuda)
    key = np.asarray([3, 77], np.uint32)
    kw = dict(cand=cand) if scored else {}
    plain_tab = cells.clone()
    plain = ops.tier_spill(plain_tab, spec, keys, key, weights, grid,
                           engine="plain", **kw)
    ksk.reset_kernel_launches()
    with ops.audit_scope() as tally:
        got = ops.tier_spill(cells, spec, keys, key, weights, grid, **kw)
    torch.cuda.synchronize()
    launches = ksk.kernel_launches()
    assert dict(tally) == {"tier_spill": 1}
    want = {k: 0 for k in launches}
    want["fused_update_score" if scored else "fused_update"] = 1
    assert launches == want
    if scored:
        (got, est), (plain, pest) = got, plain
        assert torch.equal(est, pest)
    assert got is cells
    assert torch.equal(signed_view(got), signed_view(plain_tab))


@pytest.mark.cuda
@pytest.mark.parametrize("name,packed", FORMATS)
def test_tier_query_equals_plain(cuda, name, packed):
    spec = _spec(name, packed)
    rng = np.random.default_rng(32)
    cells = _random_cells(rng, spec, (5, spec.depth), cuda)
    probes = rng.integers(0, 2**32, (5, 300), dtype=np.uint64).astype(
        np.uint32)
    ksk.reset_kernel_launches()
    got = ops.tier_query(cells, spec, probes)
    assert ksk.kernel_launches()["fused_query"] == 1
    assert torch.equal(got, ops.tier_query(cells, spec, probes,
                                           engine="plain"))
    assert torch.equal(ops.tier_query(cells, spec, probes[0])[3],
                       ops.tier_query(cells[3:4], spec, probes[0])[0])


def _tiered_pair_on_card(device, engine, wspec, hot):
    tier = TierSpec(max_hot_tenants=hot)
    svcs = []
    for t in (tier, None):
        s = CountService(wspec.sketch, tenants=[f"t{i}" for i in range(8)],
                         queue_capacity=2048, track_top=8, device=device,
                         engine=engine, tier=t)
        for n in ("x", "y", "z", "u", "v"):
            s.add_tenant(n, window=wspec)
        svcs.append(s)
    return svcs


def _churn(svcs, rng, epochs=6):
    names = [f"t{i}" for i in range(8)]
    wnames = ["x", "y", "z", "u", "v"]
    ts = 0.0
    for e in range(epochs):
        group = [names[(3 * e + i) % 8] for i in range(3)]
        wgroup = [wnames[(2 * e + i) % 5] for i in range(2)]
        ev = {n: rng.zipf(1.3, 500).astype(np.uint32) % 999 for n in group}
        ts += float(rng.exponential(50.0))
        wev = {n: rng.zipf(1.3, 400).astype(np.uint32) % 999 for n in wgroup}
        for s in svcs:
            s.enqueue_many(ev)
            s.enqueue_many(wev, ts=ts)
            s.flush()


def _trees_equal(a, b):
    _, ta = convert.service_to_numpy(a)
    _, tb = convert.service_to_numpy(b)
    for kind in ("planes", "windows"):
        for la, lb in zip(ta[kind], tb[kind]):
            assert la.keys() == lb.keys()
            for key, va in la.items():
                if isinstance(va, dict):
                    for sub, x in va.items():
                        assert np.array_equal(x, lb[key][sub]), (key, sub)
                else:
                    assert np.array_equal(va, lb[key]), key


@pytest.mark.cuda
def test_tiered_services_equal_untiered_after_churn(cuda):
    """A tiered tracked plane (3 of 8 tenants hot) and a tiered windowed
    plane (2 of 5 hot) on the kernels, after a churn stream with swaps
    and rotations: `stacked_tables`, `query_all`, windowed `query` and
    `topk` equal the untiered service's, and every leaf (cold stores and
    mirrors included) equals the tiered service's on the plain engine."""
    wspec = WindowSpec(sketch=_spec("CMLS16", True), buckets=4,
                       interval=60.0)
    ksk.reset_kernel_launches()
    tiered, untiered = _tiered_pair_on_card(cuda, "auto", wspec, 3)
    _churn((tiered, untiered), np.random.default_rng(41))
    plain, _ = _tiered_pair_on_card(cuda, "plain", wspec, 3)
    _churn((plain,), np.random.default_rng(41))
    assert tiered.metrics.counter("tier_promotions", plane="p0").value > 0
    assert tiered.metrics.counter("tier_promotions", plane="w0").value > 0
    for pt, pu in zip(tiered.planes, untiered.planes):
        assert torch.equal(signed_view(pt.stacked_tables()),
                           signed_view(pu.tables))
    probes = np.arange(200, dtype=np.uint32)
    qt, qu = tiered.query_all(probes), untiered.query_all(probes)
    for n in qt:
        assert torch.equal(qt[n], qu[n]), n
    for n in ("x", "y", "z", "u", "v"):
        for kw in ({}, {"n_buckets": 2}, {"gamma": 0.8}, {"mode": "max"}):
            assert torch.equal(tiered.query(n, probes, **kw),
                               untiered.query(n, probes, **kw)), (n, kw)
    for n in tiered.tenants:
        ka, ea = tiered.topk(n)
        kb, eb = untiered.topk(n)
        assert np.array_equal(ka, kb) and np.array_equal(ea, eb), n
    launches = ksk.kernel_launches()
    assert all(launches[k] > 0 for k in launches
               if k != "queue_append_dense"), launches
    plain.query_all(probes)
    for n in tiered.tenants:
        plain.topk(n)
    _trees_equal(tiered, plain)


@pytest.mark.cuda
def test_hot_only_tiered_epoch_does_not_synchronize(cuda):
    """With tiering on, an `enqueue_many` to hot tenants, a flush epoch
    where only hot tenants are active (no spill, no swap), a windowed
    hot-only epoch that rotates, and an `enqueue_many` that reaches cold
    tenants run under torch.cuda.set_sync_debug_mode("error"); the state
    then equals the plain engine's on the same stream."""
    wspec = WindowSpec(sketch=_spec("CMLS16", False), buckets=4,
                       interval=60.0)
    rng = np.random.default_rng(43)
    ev = {f"t{i}": rng.zipf(1.3, 600).astype(np.uint32) % 999
          for i in range(3)}
    wev = [({n: rng.zipf(1.3, 300).astype(np.uint32) % 999
             for n in ("x", "y")}, ts) for ts in (610.0, 700.0)]
    cold_ev = {n: rng.zipf(1.3, 200).astype(np.uint32) % 999
               for n in ("t1", "t6", "t7", "z", "v")}
    out = []
    for engine in ("auto", "plain"):
        svc, _ = _tiered_pair_on_card(cuda, engine, wspec, 3)
        svc.enqueue_many({n: np.arange(4, dtype=np.uint32)
                          for n in ("x", "y")}, ts=600.0)
        svc.flush()
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        if engine == "auto":
            torch.cuda.set_sync_debug_mode("error")
        try:
            with ops.audit_scope() as tally:
                svc.enqueue_many(ev)
                svc.flush()
                for w_ev, ts in wev:
                    svc.enqueue_many(w_ev, ts=ts)
                    svc.flush()
            svc.enqueue_many(cold_ev)
        finally:
            torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
        assert "tier_spill" not in tally and "tier_promote" not in tally
        assert tally["window_advance_rows"] == 1
        out.append(svc)
    _trees_equal(*out)


@pytest.mark.cuda
def test_enqueue_to_a_cold_tenant_launches_nothing(cuda):
    """An `enqueue` or `enqueue_many` that reaches only cold tenants
    touches the host mirror alone: no kernel launch, no op tally, the
    device ring unchanged."""
    wspec = WindowSpec(sketch=_spec("CMS32", False), buckets=4,
                       interval=60.0)
    svc, _ = _tiered_pair_on_card(cuda, "auto", wspec, 3)
    ring = [signed_view(p.ring.queue).clone() for p in svc.planes]
    ksk.reset_kernel_launches()
    with ops.audit_scope() as tally:
        svc.enqueue("t5", np.arange(100, dtype=np.uint32))
        svc.enqueue_many({"t6": np.arange(50, dtype=np.uint32),
                          "t7": np.arange(70, dtype=np.uint32)})
        svc.enqueue("v", np.arange(30, dtype=np.uint32), ts=5.0)
    torch.cuda.synchronize()
    assert dict(tally) == {}
    assert all(v == 0 for v in ksk.kernel_launches().values())
    for p, r in zip(svc.planes, ring):
        assert torch.equal(signed_view(p.ring.queue), r)
    assert svc.planes[0].tier.hfill[5:8].tolist() == [100, 50, 70]


# ---- the algebra slice: the decayed leaf and the probe ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("history", [8, 16, 32], ids=["b9", "b17", "b33"])
@pytest.mark.parametrize("name,packed", FORMATS)
def test_decayed_query_on_the_odd_leaf_equals_plain(cuda, name, packed,
                                                    history):
    """Kernel 7 on a decayed (B+1, d, w) leaf, B+1 = 9, 17, 33 (every
    weight non-zero, the tail last; 33 is two rounds of 32 buckets):
    equal to the plain engine, and one launch a query."""
    spec = _spec(name, packed)
    ds = tw.decayed_init(spec, gamma=0.7, history=history, device=cuda)
    rng = np.random.default_rng(history)
    for i in range(history + 3):
        keys = torch.from_numpy(rng.zipf(1.3, 3000).astype(np.int64) % 5000)
        ds = tw.decayed_update(ds, keys.to(cuda), [history, i],
                               age_step=i % 4 != 3)
    probes = np.arange(777, dtype=np.uint32)
    ksk.reset_kernel_launches()
    got = tw.decayed_query(ds, probes)
    assert ksk.kernel_launches()["window_query"] == 1
    want = tw.decayed_query(ds, probes, engine="plain")
    assert torch.equal(got, want)
    assert float(got.sum()) > 0


@pytest.mark.cuda
def test_probe_on_service_equals_plain_and_appends_without_sync(cuda):
    """A tracked service with an AccuracyProbe, kernels against the plain
    engine on the card: the same shadow counts and ARE deciles, and the
    kernels' `enqueue_many` under set_sync_debug_mode("error")."""
    from repro_torch.obs import AccuracyProbe
    spec = _spec("CMLS16", False)
    names = [f"t{i}" for i in range(4)]
    out = []
    for engine in ("auto", "plain"):
        probe = AccuracyProbe(rate=0.2, capacity=512)
        svc = CountService(spec, tenants=names, queue_capacity=4096,
                           track_top=8, device=cuda, engine=engine,
                           probe=probe)
        rng = np.random.default_rng(4)
        for _ in range(3):
            events = {n: rng.zipf(1.3, 1000).astype(np.uint32) % 999
                      for n in names}
            torch.cuda.synchronize()
            before = torch.cuda.get_sync_debug_mode()
            if engine == "auto":   # the plain engine's appends copy
                torch.cuda.set_sync_debug_mode("error")
            try:
                svc.enqueue_many(events)
            finally:
                torch.cuda.set_sync_debug_mode(before)
        svc.flush()
        out.append((probe.counts, probe.record(svc)))
    (ca, ra), (cb, rb) = out
    assert ca == cb and sorted(ra) == names
    assert ra == rb


# --------------------------------------------------------------------------
# slice 10: the replica math, topk.refresh, the examples, sharded at W = 1
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["exp", "expm1", "tanh", "log", "log1p"])
def test_xla_f32_card_equals_cpu(cuda, name):
    """The replica math is plain float32 / float64 torch ops: the same
    bits on the card as on the CPU (every CMLS16 state argument and
    log-uniform samples)."""
    import math
    from repro_torch.core import xla_f32
    rng = np.random.default_rng(5)
    states = np.arange(65536, dtype=np.float32) * np.float32(
        math.log(1.00025))
    x = np.concatenate([states, np.exp(rng.uniform(-12, 17, 200_000)),
                        rng.uniform(0, 1, 100_000)]).astype(np.float32)
    fn = getattr(xla_f32, name)
    got = fn(torch.from_numpy(x).to(cuda)).cpu().numpy()
    want = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name,packed", FORMATS)
def test_reencode_algebra_card_equals_cpu(cuda, name, packed):
    """merge(estimate_sum) with a key and without one, and decay: 0 cells
    apart between the card and the CPU."""
    spec = _spec(name, packed, width=8192)
    rng = np.random.default_rng(6)
    a, b = (tsk.update_batched(tsk.init(spec, device="cpu"),
                               torch.from_numpy(rng.zipf(1.3, 20_000)
                                                .astype(np.int64) % 9999),
                               [6, i]) for i in range(2))
    on = [tsk.Sketch(s.table.to(cuda), spec) for s in (a, b)]
    for key in ([6, 7], None):
        got = tsk.merge(*on, mode="estimate_sum", rng=key)
        want = tsk.merge(a, b, mode="estimate_sum", rng=key)
        assert torch.equal(signed_view(got.table).cpu(),
                           signed_view(want.table))
    got = tw.decay(on[0], 0.7, [6, 8])
    want = tw.decay(a, 0.7, [6, 8])
    assert torch.equal(signed_view(got.table).cpu(), signed_view(want.table))


@pytest.mark.cuda
def test_topk_refresh_card_equals_cpu(cuda):
    """A k = 16 tracker over one CMLS16 table refreshed on the card and on
    the CPU from the same table: the same keys, occupancy and estimates,
    bit for bit."""
    from repro_torch.core import topk
    spec = _spec("CMLS16", False, width=1 << 14)
    rng = np.random.default_rng(7)
    s = tsk.init(spec, device=cuda)
    tr_c, tr_h = topk.init(16, device=cuda), topk.init(16, device="cpu")
    for i in range(6):
        batch = torch.from_numpy(rng.zipf(1.3, 20_000).astype(np.int64)
                                 % 50_000)
        s = tsk.update_batched(s, batch.to(cuda), [7, i])
        host = tsk.Sketch(s.table.cpu(), spec)
        tr_c = topk.refresh(tr_c, s, batch.to(cuda))
        tr_h = topk.refresh(tr_h, host, batch)
        assert torch.equal(signed_view(tr_c.keys).cpu(),
                           signed_view(tr_h.keys))
        assert torch.equal(tr_c.filled.cpu(), tr_h.filled)
        np.testing.assert_array_equal(
            tr_c.estimates.cpu().numpy().view(np.int32),
            tr_h.estimates.numpy().view(np.int32))
    assert bool(tr_c.filled.all())


@pytest.mark.cuda
def test_examples_on_the_card_equal_the_cpu(cuda, capsys):
    """The three examples at a small size: the same numbers on the card
    as on the CPU (rankings equal, ARE and RMSE within 1e-5 relative)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "examples"))
    import quickstart_torch
    import streaming_pmi_torch
    import trending_items_torch
    runs = [(quickstart_torch, ["--events", "20000", "--kernel-events",
                                "5000"]),
            (streaming_pmi_torch, ["--tokens", "20000", "--budget-kb", "64"]),
            (trending_items_torch, ["--rotations", "4", "--per-rotation",
                                    "2000"])]
    for mod, args in runs:
        card = mod.main(args)
        host = mod.main(args + ["--device", "cpu"])
        if mod is quickstart_torch:
            assert card["kernel_estimates"] == host["kernel_estimates"]
            for k, v in host["are"].items():
                assert card["are"][k] == pytest.approx(v, rel=1e-5)
        elif mod is streaming_pmi_torch:
            assert card["rmse"] == pytest.approx(host["rmse"], rel=1e-5)
            assert card["bigrams"] == host["bigrams"]
        else:
            assert card["boards"] == host["boards"]
            assert card["hits"] == host["hits"]
    capsys.readouterr()


@pytest.mark.cuda
def test_sharded_world_one_on_nccl(cuda, tmp_path):
    """Every rank-local path of `core/sharded.py` on a one-rank NCCL
    group: the merge is the identity, the routed update / query /
    window query equal their single-device compositions (the jitted
    float graph, as under the reference's shard_map; kernel 7 for the
    window), and capacity overflow answers -1.0."""
    import torch.distributed as dist
    from repro_torch.core import sharded
    from repro_torch.launch import mesh
    mesh.init_group(1, 0, backend="nccl", init_file=str(tmp_path / "store"))
    try:
        spec = _spec("CMLS16", True)
        rng = np.random.default_rng(8)
        keys = torch.from_numpy(rng.zipf(1.3, 3000).astype(np.int64) % 5000
                                ).to(cuda)
        local = tsk.update_batched(tsk.init(spec, device=cuda), keys, [8, 0])
        merged = sharded.pmax_merge(local)
        assert torch.equal(signed_view(merged.table), signed_view(local.table))
        routed = sharded.routed_update(tsk.init(spec, device=cuda), keys,
                                       [8, 1], 4096)
        buf, _, _ = sharded._dispatch_layout(keys, 1, 4096)
        flat = buf.reshape(-1)
        want = tsk.update_batched(tsk.init(spec, device=cuda), flat, [8, 1],
                                  weights=(tc.to_i64(flat) != sharded.SENTINEL
                                           ).to(torch.float32), eager=False)
        assert torch.equal(signed_view(routed.table), signed_view(want.table))
        probes = keys[:500]
        got = sharded.routed_query(routed, probes, 4096)
        assert torch.equal(got, ops.query(routed, probes))
        small = sharded.routed_query(routed, probes, 100)
        assert bool((small[100:] == -1.0).all())
        assert torch.equal(small[:100], got[:100])
        wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
        win = tw.window_init(wspec, epoch=0, device=cuda)
        win = sharded.routed_window_update(win, keys, [8, 2], 4096, epoch=2)
        assert (win.cursor, win.epoch) == (2, 2)
        ksk.reset_kernel_launches()
        got = sharded.routed_window_query(win, probes, 4096, gamma=0.5)
        assert ksk.kernel_launches()["window_query"] == 1
        want = tw.window_query(win, probes, gamma=0.5, engine="plain")
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the recommender path (DLRM, two-tower, admission) card against CPU
# --------------------------------------------------------------------------

@pytest.fixture
def no_tf32():
    """float32 matmuls in full float32 (no TF32), restored afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev[0]
    torch.backends.cudnn.allow_tf32 = prev[1]
    torch.set_float32_matmul_precision(prev[2])


def _rel(card, host) -> float:
    """Normwise relative error max |card - host| / max |host|."""
    card = card.detach().cpu().double()
    host = host.detach().cpu().double()
    return float((card - host).abs().max() / host.abs().max().clamp_min(1e-30))


def _recsys_runs(model: str, steps: int = 3):
    """(forward, losses, params) of `steps` train steps of a smoke model
    from the same weights and batches, on the card and on the CPU."""
    from repro_torch import convert
    from repro_torch.configs import dlrm_mlperf, two_tower
    from repro_torch.data import recsys_stream
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    from repro_torch.train import loop, optimizer
    if model == "dlrm":
        c = dlrm_mlperf.SMOKE
        specs, loss = rs.dlrm_specs(c), rs.dlrm_loss
        fwd = rs.dlrm_apply
        batches = [recsys_stream.dlrm_batch(
            s, 0, 1, global_batch=64, table_sizes=list(c.table_sizes))
            for s in range(steps)]
    else:
        c = two_tower.SMOKE
        specs, loss = rs.twotower_specs(c), rs.twotower_loss
        fwd = lambda p, b, c: torch.cat(rs.twotower_embed(p, b, c), dim=1)
        batches = []
        for s in range(steps):
            b = recsys_stream.twotower_batch(s, 0, 1, global_batch=64,
                                             n_users=c.n_users,
                                             n_items=c.n_items)
            b["item_logq"] = np.log(
                (b["item_id"] % 97 + 1) / 1000.0).astype(np.float32)
            batches.append(b)
    p0 = convert.params_to_numpy(mp.init_tree(specs, 0, "cpu"))
    out = {}
    for dev in ("cuda", "cpu"):
        params = convert.params_from_numpy(p0, dev)
        tb = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
              for b in batches]
        forward = fwd(params, tb[0], c)
        init, step = loop.make_train_step(
            lambda p, b, r: loss(p, b, c),
            optimizer.OptimizerConfig(peak_lr=2e-3, warmup_steps=2,
                                      decay_steps=steps))
        state = init(params, np.array([0, 2], np.uint32))
        losses = []
        for b in tb:
            state, m = step(state, b)
            losses.append(m["loss"])
        out[dev] = (forward, torch.stack(losses), state.params)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["dlrm", "two_tower"])
def test_recsys_card_equals_cpu_forward_and_three_steps(cuda, no_tf32, model):
    """Smoke configs: the forward pass within 1e-5 and three train steps
    (losses, every parameter) within 1e-4 of the CPU's, relative."""
    from repro_torch.models.params import flatten
    out = _recsys_runs(model)
    (fc, lc, pc), (fh, lh, ph) = out["cuda"], out["cpu"]
    assert bool(torch.isfinite(fc).all()) and _rel(fc, fh) <= 1e-5
    assert _rel(lc, lh) <= 1e-5
    hp = flatten(ph)
    for k, v in flatten(pc).items():
        assert v.device.type == "cuda" and _rel(v, hp[k]) <= 1e-4, k


@pytest.mark.cuda
def test_observe_and_admit_kernel_equals_xla_on_26_fields(cuda):
    """Three 26-field `dlrm_batch`es counted in one CMLS16 sketch:
    engine "kernel" (kernels 5 and 1) equals "xla" on the card and on the
    CPU: tables, rows and masks exact at every step."""
    from repro_torch.core import CMLS16, SketchSpec
    from repro_torch.data import recsys_stream
    from repro_torch.models import recsys as rs
    spec = SketchSpec.from_memory(64 * 1024, depth=2, counter=CMLS16)
    aspec = tadm.AdmissionSpec(threshold=3.0, n_fallback=32, table_rows=96)
    kern = tsk.init(spec, device=cuda)
    xla = tsk.init(spec, device=cuda)
    host = tsk.init(spec, device="cpu")
    key = np.array([0, 1], np.uint32)
    ksk.reset_kernel_launches()
    for step in range(3):
        b = recsys_stream.dlrm_batch(step, 0, 1, global_batch=512,
                                     table_sizes=rs.criteo_tables())
        flat = torch.from_numpy(b["sparse"].reshape(-1).astype(np.int64)
                                ).to(torch.uint32)
        key, k = prng.split(key, 2)
        kern, rk, ak = tadm.observe_and_admit(kern, flat.to(cuda), k, aspec,
                                              engine="kernel")
        xla, rx, ax = tadm.observe_and_admit(xla, flat.to(cuda), k, aspec,
                                             engine="xla")
        host, rh, ah = tadm.observe_and_admit(host, flat, k, aspec)
        assert torch.equal(signed_view(kern.table), signed_view(xla.table))
        assert torch.equal(signed_view(kern.table).cpu(),
                           signed_view(host.table))
        assert torch.equal(rk, rx) and torch.equal(rk.cpu(), rh)
        assert torch.equal(ak, ax) and torch.equal(ak.cpu(), ah)
    assert 0 < int(ak.sum()) < flat.numel()
    launches = ksk.kernel_launches()
    assert launches["fused_update"] == 3 and launches["fused_query"] == 3


@pytest.mark.cuda
def test_untouched_table_rows_exact_after_a_step(cuda):
    """One DLRM train step on the card: every table row no id of the batch
    looked up is bit-identical to its start; the looked-up rows moved."""
    from repro_torch.data import recsys_stream
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    from repro_torch.train import loop, optimizer
    c = rs.DLRMConfig(embed_dim=16, bot_mlp=(13, 32, 16), top_mlp=(64, 1),
                      table_sizes=(4096,) * 26)
    params = mp.init_tree(rs.dlrm_specs(c), 0, cuda)
    start = {k: v.clone() for k, v in params["tables"].items()}
    b = recsys_stream.dlrm_batch(0, 0, 1, global_batch=256,
                                 table_sizes=list(c.table_sizes))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
    init, step = loop.make_train_step(lambda p, bt, r: rs.dlrm_loss(p, bt, c),
                                      optimizer.OptimizerConfig())
    state, m = step(init(params, np.array([0, 2], np.uint32)), batch)
    assert bool(torch.isfinite(m["loss"]))
    for i in range(c.n_sparse):
        t = state.params["tables"][f"t{i}"]
        moved = (t.view(torch.int32) != start[f"t{i}"].view(torch.int32)
                 ).any(dim=1)
        touched = torch.zeros(t.shape[0], dtype=torch.bool, device=cuda)
        touched[batch["sparse"][:, i].long()] = True
        assert not bool((moved & ~touched).any()), i
        assert bool(moved[touched].all()), i


# --------------------------------------------------------------------------
# the LM and sequential-recommender scaffold card against CPU
# --------------------------------------------------------------------------

LM_FWD = 1e-5     # logits, losses, caches, decode logits (normwise)
LM_GRAD = 1e-4    # gradients


def _lm_runs(name: str) -> list:
    """[card, CPU] results of one LM smoke config from the same float32
    weights: logits, loss, gradients, prefill cache and four decodes."""
    from repro_torch.configs import registry
    from repro_torch.models import params as mp
    from repro_torch.models import transformer as tf
    cfg = registry.get(name).smoke_cfg
    p0 = convert.params_to_numpy(mp.init_tree(tf.param_specs(cfg), 0, "cpu"))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    out = []
    for dev in ("cuda", "cpu"):
        t = torch.from_numpy(toks).to(dev)
        leaves = {k: v.requires_grad_() for k, v in mp.flatten(
            convert.params_from_numpy(p0, dev)).items()}
        loss, _ = tf.loss_fn(mp.unflatten(leaves),
                             {"tokens": t, "targets": t.roll(-1, 1)}, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params = mp.unflatten({k: v.detach() for k, v in leaves.items()})
        with torch.no_grad():
            logits, _ = tf.apply(params, t, cfg)
            _, cache = tf.prefill(params, t[:, :12], cfg, 16)
            prefilled = mp.flatten(cache)
            decs = []
            for pos in range(12, 16):
                d, cache = tf.decode_step(params, cache, t[:, pos:pos + 1],
                                          torch.tensor(pos), cfg)
                decs.append(d)
        out.append({"logits": logits, "loss": loss.detach(),
                    "grads": dict(zip(leaves, grads)), "cache": prefilled,
                    "decode": torch.stack(decs)})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-0.5b", "phi3-mini-3.8b",
                                  "gemma2-27b", "llama4-scout-17b-a16e",
                                  "deepseek-v2-lite-16b"])
def test_lm_card_equals_cpu(cuda, no_tf32, name):
    card, host = _lm_runs(name)
    assert card["logits"].device.type == "cuda"
    for k in ("logits", "loss", "decode"):
        assert _rel(card[k], host[k]) <= LM_FWD, k
    for k, v in card["cache"].items():
        assert _rel(v.float(), host["cache"][k].float()) <= LM_FWD, k
    for k, v in card["grads"].items():
        assert _rel(v, host["grads"][k]) <= LM_GRAD, k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sasrec", "bert4rec"])
def test_seqrec_card_equals_cpu(cuda, no_tf32, name):
    """Encoding, the loss with one raw key and its gradients within
    LM_FWD / LM_GRAD; `topk_over_catalog` ids equal."""
    from repro_torch.configs import registry
    from repro_torch.data import recsys_stream
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    cfg = registry.get(name).smoke_cfg
    loss_fn = rs.sasrec_loss if name == "sasrec" else rs.bert4rec_loss
    p0 = convert.params_to_numpy(mp.init_tree(rs.sasrec_specs(cfg), 0,
                                              "cpu"))
    b = recsys_stream.seq_batch(0, 0, 1, global_batch=64,
                                n_items=cfg.n_items, seq_len=cfg.seq_len)
    out = []
    for dev in ("cuda", "cpu"):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        leaves = {k: v.requires_grad_() for k, v in mp.flatten(
            convert.params_from_numpy(p0, dev)).items()}
        params = mp.unflatten(leaves)
        loss, _ = loss_fn(params, batch, cfg, np.array([0, 7], np.uint32))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            h = rs.sasrec_encode(params, batch["history"], cfg)
            v, ids = rs.topk_over_catalog(params, h[:, -1], cfg, k=20,
                                          chunk=64)
        out.append((h, loss.detach(), grads, v, ids))
    (hc, lc, gc, vc, ic), (hh, lh, gh, vh, ih) = out
    assert _rel(hc, hh) <= LM_FWD and _rel(lc, lh) <= LM_FWD
    assert _rel(vc, vh) <= LM_FWD and torch.equal(ic.cpu(), ih)
    for a, b_ in zip(gc, gh):
        assert _rel(a, b_) <= LM_GRAD


@pytest.mark.cuda
def test_topk_over_catalog_ties_on_the_card(cuda):
    """1,000,000 items in 65,536-id chunks on the card: the last chunk's
    clamped copies of item 999,999 and two distinct items with its score
    lead, lower id first, as on the CPU."""
    import dataclasses
    from repro_torch.models import recsys as rs
    cfg = dataclasses.replace(rs.SASRecConfig(), embed_dim=8)
    rng = np.random.default_rng(13)
    items = rng.normal(size=(cfg.n_items + 1, 8)).astype(np.float32)
    items[[5, 65_536, 999_999]] = 6.0
    h = np.abs(rng.normal(size=(3, 8))).astype(np.float32)
    got = [rs.topk_over_catalog({"items": torch.from_numpy(items).to(d)},
                                torch.from_numpy(h).to(d), cfg, k=100)
           for d in ("cuda", "cpu")]
    assert torch.equal(got[0][1].cpu(), got[1][1])
    ids = got[1][1].numpy()
    assert (ids[:, :2] == [5, 65_536]).all() and (ids[:, 2:] == 999_999).all()
    assert _rel(got[0][0], got[1][0]) <= LM_FWD


# --------------------------------------------------------------------------
# DimeNet and the routed exchange card against CPU (no kernel on either)
# --------------------------------------------------------------------------

# DimeNet's segment sums add with atomics on the card (index_add), in
# index order on the CPU: outputs and losses within GNN_FWD, gradients
# within GNN_GRAD (normwise), the tolerances the CPU tests hold the port
# to the JAX package with
GNN_FWD = 1e-5
GNN_GRAD = 1e-4


def _gnn_case(readout: str):
    """(config, numpy batch) of a DimeNet smoke case: batched molecules
    (graph readout) or a synthetic graph with features (node readout)."""
    import dataclasses
    from repro_torch.configs import dimenet as dcfg
    from repro_torch.data import graph
    rng = np.random.default_rng(3)
    if readout == "graph":
        cfg = dataclasses.replace(dcfg.SMOKE, readout="graph")
        m = graph.batched_molecules(8, 12, 24, seed=0)
        kj, ji, valid = graph.build_triplets(m["edge_src"], m["edge_dst"],
                                             96, 4, rng)
        b = {k: m[k] for k in ("pos", "atom_z", "edge_src", "edge_dst",
                               "graph_id", "n_graphs")}
        b["target"] = rng.normal(size=8).astype(np.float32)
    else:
        cfg = dataclasses.replace(dcfg.SMOKE, readout="node", d_feat=8,
                                  n_targets=5)
        g = graph.synthetic_graph(256, 2048, seed=1)
        src = g.indices.astype(np.int32)
        dst = np.repeat(np.arange(256), np.diff(g.indptr)).astype(np.int32)
        kj, ji, valid = graph.build_triplets(src, dst, 256, 3, rng)
        b = {"pos": rng.normal(size=(256, 3)).astype(np.float32),
             "x_feat": rng.normal(size=(256, 8)).astype(np.float32),
             "edge_src": src, "edge_dst": dst,
             "label": rng.integers(0, 5, 256).astype(np.int32)}
    b.update(t_kj=kj, t_ji=ji, t_mask=valid.astype(np.float32),
             edge_mask=np.ones(len(b["edge_src"]), np.float32))
    return cfg, b


def _gnn_params(cfg) -> dict:
    """Parameters with nonzero output heads (every leaf gets a gradient)."""
    from repro_torch.models import dimenet as dn
    from repro_torch.models import params as mp
    rng = np.random.default_rng(4)
    return mp.unflatten({
        k: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(
            np.float32) for k, s in mp.flatten(dn.param_specs(cfg)).items()})


@pytest.mark.cuda
@pytest.mark.parametrize("readout", ["graph", "node"])
def test_dimenet_card_equals_cpu(cuda, no_tf32, readout):
    from repro_torch.models import dimenet as dn
    from repro_torch.models import params as mp
    cfg, b = _gnn_case(readout)
    p0 = _gnn_params(cfg)
    out = []
    for dev in ("cuda", "cpu"):
        batch = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                 else v for k, v in b.items()}
        leaves = {k: v.requires_grad_() for k, v in mp.flatten(
            convert.params_from_numpy(p0, dev)).items()}
        loss, _ = dn.loss_fn(mp.unflatten(leaves), batch, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            y = dn.apply(mp.unflatten(leaves), batch, cfg)
        out.append((y, loss.detach(), dict(zip(leaves, grads))))
    (yc, lc, gc), (yh, lh, gh) = out
    assert yc.device.type == "cuda" and bool(torch.isfinite(yc).all())
    assert _rel(yc, yh) <= GNN_FWD and _rel(lc, lh) <= GNN_FWD
    for k, g in gc.items():
        assert _rel(g, gh[k]) <= GNN_GRAD, k


@pytest.mark.cuda
def test_routed_functions_world_one_on_nccl(cuda, no_tf32, tmp_path):
    """At world size 1 on NCCL the routed forms equal the unrouted ones:
    `route` / `send_back` (rows past the capacity come back zero), the
    MoE all-to-all and `moe_apply` (float32, no token dropped), the int8
    all-reduce and `dequantize(quantize(g))`, the routed DLRM lookup and
    `dlrm_lookup`, the routed sparse step and the unrouted one, and
    DimeNet's `loss_fn_sharded` and `loss_fn`."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import routing
    from repro_torch.data import recsys_stream
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import dimenet as dn
    from repro_torch.models import moe
    from repro_torch.models import params as mp
    from repro_torch.models import recsys as rs
    from repro_torch.train import compression, optimizer
    mesh_lib.init_group(1, 0, backend="nccl",
                        init_file=str(tmp_path / "store"))
    try:
        mesh = mesh_lib.make_host_mesh(1)
        rng = np.random.default_rng(9)
        x = torch.from_numpy(rng.normal(size=(300, 4)).astype(np.float32)
                             ).to(cuda)
        dest = torch.zeros(300, dtype=torch.int64, device=cuda)
        recv, rt = routing.route(x, dest, 256)
        back = routing.send_back(recv * 2.0, rt)
        assert int(rt.kept.sum()) == 256
        assert torch.equal(back[rt.kept], x[rt.kept] * 2.0)
        assert not bool(back[~rt.kept].any())

        c = moe.MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff_expert=32,
                          n_shared=1, norm_topk=True, capacity_factor=4.0,
                          wire_capacity_factor=4.0)
        p = mp.init_tree(moe.moe_specs(c), 0, cuda)
        xt = torch.randn(512, 64, device=cuda)
        y_a, aux_a = moe.moe_apply_a2a(p, xt, c)
        y, aux = moe.moe_apply(p, xt, c)
        assert float((y_a - y).abs().max()) < 1e-5
        assert float((aux_a - aux).abs()) < 1e-6

        g = torch.randn(10_000, device=cuda) * 3.0
        want = compression.dequantize(*compression.quantize(g), g.shape)
        assert torch.equal(compression.compressed_allreduce_mean(g), want)

        dc = rs.DLRMConfig(embed_dim=16, bot_mlp=(13, 32, 16),
                           top_mlp=(64, 1), table_sizes=(20_480,) * 3 + (60,),
                           lookup="a2a")
        b = {k: torch.from_numpy(v).to(cuda) for k, v in
             recsys_stream.dlrm_batch(0, 0, 1, global_batch=256,
                                      table_sizes=list(dc.table_sizes)
                                      ).items()}
        params = mp.init_tree(rs.dlrm_specs(dc), 0, cuda)
        assert torch.equal(rs.dlrm_lookup_a2a(params["tables"], b["sparse"],
                                              dc, mesh),
                           rs.dlrm_lookup(params["tables"], b["sparse"], dc))
        ocfg = optimizer.OptimizerConfig(table_lr=0.1)
        _, dense_update = optimizer.make_optimizer(
            ocfg, label_fn=lambda path: "dense")
        runs = []
        for use_mesh in (mesh, None):
            pr = {k: {n: t.clone() for n, t in v.items()}
                  for k, v in params.items()}
            st = {"dense": {k: {n: {"mu": torch.zeros_like(t),
                                    "nu": torch.zeros_like(t)}
                                for n, t in pr[k].items()}
                            for k in ("bot", "top")},
                  "tables": {k: {"acc": torch.zeros(t.shape[0],
                                                    device=cuda)}
                             for k, t in pr["tables"].items()}}
            pr, st, m = rs.dlrm_train_step_sparse(pr, st, b, 0, 0, dc, ocfg,
                                                  dense_update, use_mesh)
            runs.append((pr, m["loss"]))
        assert torch.equal(runs[0][1], runs[1][1])
        for k, t in runs[0][0]["tables"].items():
            # bf16 gradients on the routed path's wire
            assert _rel(t, runs[1][0]["tables"][k]) <= 1e-2, k

        cfg, gb = _gnn_case("node")
        batch = {k: torch.from_numpy(v).to(cuda)
                 for k, v in gb.items()}
        gp = convert.params_from_numpy(_gnn_params(cfg), cuda)
        ls, _ = dn.loss_fn_sharded(gp, batch,
                                   dataclasses.replace(cfg,
                                                       local_triplets=True))
        lw, _ = dn.loss_fn(gp, batch, cfg)
        assert _rel(ls, lw) <= GNN_FWD
    finally:
        dist.destroy_process_group()
