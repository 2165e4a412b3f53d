"""The port's sharded sketches on `torch.distributed` (gloo, CPU) against
compositions of the JAX package's own pieces.

One spawn of W = 2 and one of W = 4 gloo ranks (`run`, below) runs
every function of `repro_torch/core/sharded.py`; the parent rebuilds
each rank's inputs and composes the reference's answer from its pure
single-device pieces (the reference's `shard_map` tests need a multi-device
JAX, which this JAX does not run):

  * `pmax_merge` / `pmax_merge_window_stack` == `storage_table` of the
    elementwise max of the reference's logical tables, in all five
    formats, packed included; `pmax_merge_tier_stack` the same over
    `sharded.tier_assemble`, `pmax_merge_window` over a ring;
  * `lazy_update` / `lazy_update_window` == `update_batched` /
    `window_update`, merged on the merge step only;
  * rank r's `routed_update` == `update_batched(local, concat_j
    _dispatch_layout(keys_j, W, cap)[0][r], rng, weights=valid)`, the
    epoch-driven `routed_window_update` the same after
    `window_advance_steps(max(epoch - win.epoch, 0))`;
  * `routed_query` / `routed_window_query` == the reference's query of
    the received probes routed back by slot, -1.0 past the capacity;
  * `routed_topk` == `lax.top_k` of the gathered candidates,
    `routed_admit` == `admission.admit_tracked` on them, and
    `merged_metrics` sum / max (and its error on another mode).

Tolerance: none.  States, keys, masks, rows, metric values and answers
(bit for bit, -1.0 overflow markers included) are exact.  The
reference's functions run inside `shard_map`, so under jit: the
compositions of its pieces that stand in for them here run under
`jax.jit` too, and the port takes the jitted float graph
(`core/xla_f32.py`).
"""
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.core import admission as jadm
from repro.core import counters as jc
from repro.core import sharded as jsh
from repro.core import sketch as jsk
from repro.stream import WindowSpec as JWindowSpec
from repro.stream import window as jw

JOIN_TIMEOUT = 150.0


# --------------------------------------------------------------------------
# one rank: every function of core/sharded.py on a gloo group (the spawned
# children import this module by name; `inputs` rebuilds a rank's inputs
# in the parent too)
# --------------------------------------------------------------------------

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]
WIDTH, DEPTH, BUCKETS, TENANTS, HOT = 512, 2, 3, 5, 2
CAP, SMALL_CAP, N_KEYS, K = 256, 24, 300, 6
MAX_STATE = {"CMS32": 2**32 - 1, "CMLS16": 65535, "CMLS8": 255}


def states(rng, name, shape):
    """Random logical cell states, some at the format's top."""
    top = MAX_STATE[name]
    s = rng.integers(0, min(top, 3000) + 1, shape, dtype=np.int64)
    s.reshape(-1)[:3] = top
    return s


def inputs(rank: int, world: int) -> dict:
    rng = np.random.default_rng(1000 * world + rank)
    out = {}
    for name, packed in FORMATS:
        out[f"table/{name}/{packed}"] = states(rng, name, (DEPTH, WIDTH))
        out[f"stack/{name}/{packed}"] = states(
            rng, name, (TENANTS, BUCKETS, DEPTH, WIDTH))
    out["hot"] = states(rng, "CMLS16", (HOT, DEPTH, WIDTH))
    out["cold"] = states(rng, "CMLS16", (TENANTS, DEPTH, WIDTH))
    out["slot_tenant"] = np.array([3, 1], np.int64)
    keys = (rng.zipf(1.3, N_KEYS) % 400).astype(np.uint32)
    keys[:2] = [0, 0xFFFF_FFFE]
    out["keys"] = keys
    out["probes"] = np.concatenate([keys[:40], np.arange(40, dtype=np.uint32)])
    out["tr_keys"] = rng.integers(0, 50, K).astype(np.uint32)
    out["tr_filled"] = rng.random(K) < 0.7
    out["tr_est"] = np.where(out["tr_filled"], rng.integers(0, 20, K),
                             -np.inf).astype(np.float32)
    out["ids"] = rng.integers(0, 50, 64).astype(np.uint32)
    out["metrics"] = rng.integers(0, 1000, 7).astype(np.float32)
    return out


def key_of(rank: int, salt: int) -> np.ndarray:
    return np.array([salt, rank], np.uint32)


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core import admission, counters, sharded, topk
    from repro_torch.core import sketch as sk
    from repro_torch.core.sketch import SketchSpec
    from repro_torch.launch import mesh
    from repro_torch.stream import window as w

    mesh.init_group(world, rank, backend="gloo", init_file=init_file)
    inp = inputs(rank, world)
    res = {}

    def spec_of(name, packed):
        return SketchSpec(width=WIDTH, depth=DEPTH,
                          counter=getattr(counters, name), packed=packed)

    def store(s, spec):
        return sk.storage_table(torch.from_numpy(s), spec)

    for name, packed in FORMATS:
        spec = spec_of(name, packed)
        tag = f"{name}/{packed}"
        local = sk.Sketch(store(inp[f"table/{tag}"], spec), spec)
        res[f"pmax/{tag}"] = counters.to_numpy(
            sharded.pmax_merge(local).table)
        res[f"stack/{tag}"] = counters.to_numpy(
            sharded.pmax_merge_window_stack(
                store(inp[f"stack/{tag}"], spec), spec))

    spec = spec_of("CMLS16", True)
    wspec = w.WindowSpec(sketch=spec, buckets=BUCKETS, interval=60.0)
    hot, full = sharded.pmax_merge_tier_stack(
        store(inp["hot"], spec), inp["slot_tenant"],
        store(inp["cold"], spec), spec)
    res["tier_hot"] = counters.to_numpy(hot)
    res["tier_full"] = counters.to_numpy(full)

    keys = torch.from_numpy(inp["keys"].astype(np.int64))
    local = sk.Sketch(store(inp["table/CMLS16/True"], spec), spec)
    for step in (0, 1):  # merge_every=2 merges on step 1 only
        res[f"lazy/{step}"] = counters.to_numpy(sharded.lazy_update(
            local, keys, key_of(rank, 10 + step), step, 2).table)
    ring = w.WindowedSketch(tables=store(inp["stack/CMLS16/True"][0], spec),
                            cursor=1, spec=wspec, epoch=0)
    res["pmax_window"] = counters.to_numpy(
        sharded.pmax_merge_window(ring).tables)
    for step in (0, 1):
        res[f"lazy_window/{step}"] = counters.to_numpy(
            sharded.lazy_update_window(ring, keys, key_of(rank, 20 + step),
                                       step, 2).tables)

    # key-routed: update, query (and capacity overflow), windows
    routed = sharded.routed_update(sk.init(spec, device="cpu"), keys,
                                   key_of(rank, 30), CAP)
    res["routed_update"] = counters.to_numpy(routed.table)
    probes = torch.from_numpy(inp["probes"].astype(np.int64))
    res["routed_query"] = sharded.routed_query(routed, probes, CAP).numpy()
    res["routed_query_small"] = sharded.routed_query(
        routed, keys, SMALL_CAP).numpy()
    win = w.window_init(wspec, epoch=0, device="cpu")
    win = sharded.routed_window_update(win, keys, key_of(rank, 40), CAP,
                                       epoch=2)
    win = sharded.routed_window_update(win, torch.flip(keys, [0]),
                                       key_of(rank, 41), CAP, epoch=1)
    res["routed_window"] = counters.to_numpy(win.tables)
    res["routed_window_cursor"] = np.array([win.cursor, win.epoch])
    res["routed_window_query"] = sharded.routed_window_query(
        win, probes, CAP).numpy()
    res["routed_window_query_gamma"] = sharded.routed_window_query(
        win, probes, SMALL_CAP, gamma=0.5, n_buckets=2).numpy()

    # candidates: routed_topk, routed_admit, merged metrics
    tracker = topk.TopK(
        keys=counters.from_numpy(inp["tr_keys"], "cpu"),
        estimates=torch.from_numpy(inp["tr_est"]),
        filled=torch.from_numpy(inp["tr_filled"]))
    for k in (K, 3):
        top = sharded.routed_topk(tracker, k=k)
        res[f"topk/{k}/keys"] = counters.to_numpy(top.keys)
        res[f"topk/{k}/est"] = top.estimates.numpy()
        res[f"topk/{k}/filled"] = top.filled.numpy()
    aspec = admission.AdmissionSpec(threshold=8.0, n_fallback=64,
                                    table_rows=1024)
    rows, admitted = sharded.routed_admit(tracker, inp["ids"], aspec)
    res["admit_rows"] = rows.numpy()
    res["admit_mask"] = admitted.numpy()
    values = torch.from_numpy(inp["metrics"])
    res["metrics_sum"] = sharded.merged_metrics(values).numpy()
    res["metrics_max"] = sharded.merged_metrics(values, mode="max").numpy()
    try:
        sharded.merged_metrics(values, mode="mean")
        res["metrics_error"] = np.array(False)
    except ValueError:
        res["metrics_error"] = np.array(True)
    np.savez(f"{out_dir}/rank{rank}.npz", **res)
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the parent: the reference's compositions
# --------------------------------------------------------------------------

def _spawn(world: int) -> list[dict]:
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(run, args=(world, f"{tmp}/store", tmp),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"W={world} ranks still running "
                                       f"after {JOIN_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        return [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    world = request.param
    return world, _spawn(world), [inputs(r, world) for r in range(world)]


def _jspec(name="CMLS16", packed=True):
    return jsk.SketchSpec(width=WIDTH, depth=DEPTH,
                          counter=getattr(jc, name), packed=packed)


def _store(states, spec):
    return jsk.storage_table(jnp.asarray(states.astype(spec.counter.dtype)),
                             spec)


def _logical(table, spec):
    return np.asarray(jsk.logical_table(jnp.asarray(table), spec), np.int64)


def _max_store(tables, spec):
    """storage_table of the elementwise max of the logical tables."""
    return np.asarray(_store(np.max([_logical(t, spec) for t in tables],
                                    axis=0), spec))


def _key(rank, salt):
    return jnp.asarray(key_of(rank, salt))


def _same_answers(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# the reference's pieces as `shard_map` compiles them
_update_batched = jax.jit(jsk.update_batched)
_query = jax.jit(jsk.query)
_window_update = jax.jit(jw.window_update)


def test_pmax_merges_match(ranks):
    world, res, inp = ranks
    for name, packed in FORMATS:
        spec, tag = _jspec(name, packed), f"{name}/{packed}"
        want = _max_store([_store(i[f"table/{tag}"], spec) for i in inp], spec)
        stack = _max_store([_store(i[f"stack/{tag}"], spec) for i in inp],
                           spec)
        for r in range(world):
            np.testing.assert_array_equal(res[r][f"pmax/{tag}"], want, tag)
            np.testing.assert_array_equal(res[r][f"stack/{tag}"], stack, tag)
    spec = _jspec()
    full = _max_store([jsh.tier_assemble(_store(i["hot"], spec),
                                         i["slot_tenant"],
                                         _store(i["cold"], spec))
                       for i in inp], spec)
    ring = _max_store([_store(i["stack/CMLS16/True"][0], spec) for i in inp],
                      spec)
    for r in range(world):
        np.testing.assert_array_equal(res[r]["tier_full"], full)
        np.testing.assert_array_equal(res[r]["tier_hot"],
                                      full[inp[r]["slot_tenant"]])
        np.testing.assert_array_equal(res[r]["pmax_window"], ring)


def test_lazy_updates_match(ranks):
    world, res, inp = ranks
    spec = _jspec()
    wspec = JWindowSpec(sketch=spec, buckets=BUCKETS, interval=60.0)
    for step in (0, 1):
        local = [_update_batched(
            jsk.Sketch(_store(i["table/CMLS16/True"], spec), spec),
            jnp.asarray(i["keys"]), _key(r, 10 + step)).table
            for r, i in enumerate(inp)]
        rings = [_window_update(
            jw.WindowedSketch(tables=_store(i["stack/CMLS16/True"][0], spec),
                              cursor=jnp.int32(1), spec=wspec,
                              epoch=jnp.int32(0)),
            jnp.asarray(i["keys"]), _key(r, 20 + step)).tables
            for r, i in enumerate(inp)]
        for r in range(world):
            want = _max_store(local, spec) if step else np.asarray(local[r])
            np.testing.assert_array_equal(res[r][f"lazy/{step}"], want)
            want = _max_store(rings, spec) if step else np.asarray(rings[r])
            np.testing.assert_array_equal(res[r][f"lazy_window/{step}"],
                                          want)


def _received(inp, field, rank, world, cap):
    """What `rank` receives: row `rank` of every rank's dispatch layout."""
    return jnp.concatenate([jsh._dispatch_layout(
        jnp.asarray(i[field]), world, cap)[0][rank] for i in inp])


def _routed_answers(inp, field, world, cap, answer):
    """The reference's routed read composed: each rank answers what it
    received (`answer(rank, probes)`), fill slots answer 0, and every
    origin gathers its keys' answers by slot (-1.0 past the capacity)."""
    est = []
    for r in range(world):
        recv = _received(inp, field, r, world, cap)
        e = np.asarray(answer(r, recv), np.float32)
        est.append(np.where(np.asarray(recv) == int(jsh.SENTINEL), 0.0, e)
                   .reshape(world, cap))
    out = []
    for j, i in enumerate(inp):
        _, slot, kept = jsh._dispatch_layout(jnp.asarray(i[field]), world, cap)
        back = np.concatenate([est[r][j] for r in range(world)] + [[-1.0]])
        got = back[np.minimum(np.asarray(slot), world * cap)]
        out.append(np.where(np.asarray(kept), got, -1.0).astype(np.float32))
    return out


def test_routed_sketch_matches(ranks):
    world, res, inp = ranks
    spec = _jspec()
    local = []
    for r in range(world):
        recv = _received(inp, "keys", r, world, CAP)
        s = _update_batched(jsk.init(spec), recv, _key(r, 30),
                            weights=(recv != jsh.SENTINEL).astype(
                                jnp.float32))
        np.testing.assert_array_equal(res[r]["routed_update"], s.table)
        local.append(s)
    for field, cap, out in (("probes", CAP, "routed_query"),
                            ("keys", SMALL_CAP, "routed_query_small")):
        want = _routed_answers(inp, field, world, cap,
                               lambda r, q: _query(local[r], q))
        for r in range(world):
            _same_answers(res[r][out], want[r])
    # the small capacity overflows: dropped keys answer -1.0
    assert (res[0]["routed_query_small"] == -1.0).any()
    assert not (res[0]["routed_query"] == -1.0).any()


def test_routed_window_matches(ranks):
    world, res, inp = ranks
    spec = _jspec()
    wspec = JWindowSpec(sketch=spec, buckets=BUCKETS, interval=60.0)
    wins = []
    for r in range(world):
        win = jw.window_init(wspec, epoch=0)
        for epoch, field, salt in ((2, "keys", 40), (1, "rev", 41)):
            steps = jnp.maximum(jnp.int32(epoch) - win.epoch, 0)
            win = jw.window_advance_steps(win, steps)
            recv = jnp.concatenate([jsh._dispatch_layout(
                jnp.asarray(i["keys"] if field == "keys"
                            else i["keys"][::-1].copy()),
                world, CAP)[0][r] for i in inp])
            win = _window_update(win, recv, _key(r, salt),
                                 weights=(recv != jsh.SENTINEL).astype(
                                     jnp.float32))
        np.testing.assert_array_equal(res[r]["routed_window"], win.tables)
        assert res[r]["routed_window_cursor"].tolist() == [
            int(win.cursor), int(win.epoch)] == [2, 2]
        wins.append(win)
    for cap, kw, out in ((CAP, {}, "routed_window_query"),
                         (SMALL_CAP, {"gamma": 0.5, "n_buckets": 2},
                          "routed_window_query_gamma")):
        want = _routed_answers(inp, "probes", world, cap,
                               lambda r, q: jw.window_query(wins[r], q, **kw))
        for r in range(world):
            _same_answers(res[r][out], want[r])


def test_routed_candidates_and_metrics_match(ranks):
    world, res, inp = ranks
    keys = np.concatenate([i["tr_keys"] for i in inp])
    est = np.concatenate([i["tr_est"] for i in inp])
    filled = np.concatenate([i["tr_filled"] for i in inp])
    for k in (K, 3):
        masked = jnp.where(jnp.asarray(filled), jnp.asarray(est), -jnp.inf)
        top_est, idx = jax.lax.top_k(masked, k)
        for r in range(world):
            np.testing.assert_array_equal(res[r][f"topk/{k}/keys"],
                                          keys[np.asarray(idx)])
            np.testing.assert_array_equal(res[r][f"topk/{k}/est"], top_est)
            np.testing.assert_array_equal(res[r][f"topk/{k}/filled"],
                                          np.asarray(top_est) > -np.inf)
    spec = jadm.AdmissionSpec(threshold=8.0, n_fallback=64, table_rows=1024)
    values = np.stack([i["metrics"] for i in inp])
    for r in range(world):
        rows, mask = jadm.admit_tracked(jnp.asarray(keys), jnp.asarray(est),
                                        jnp.asarray(filled),
                                        jnp.asarray(inp[r]["ids"]), spec)
        np.testing.assert_array_equal(res[r]["admit_rows"], rows)
        np.testing.assert_array_equal(res[r]["admit_mask"], mask)
        np.testing.assert_array_equal(res[r]["metrics_sum"],
                                      values.sum(axis=0))
        np.testing.assert_array_equal(res[r]["metrics_max"],
                                      values.max(axis=0))
        assert bool(res[r]["metrics_error"])
