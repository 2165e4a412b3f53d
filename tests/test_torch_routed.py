"""The port's routed exchange on `torch.distributed` against the JAX
package's single-device pieces (CPU).

In one process: `routing._pack` / `local_group_by` / `ungroup` slot for
slot against the reference's own functions (capacity drops included),
`quantize` / `dequantize` / `compress_with_feedback` bit for bit, the
rule tables and `spec_for` (the four cases of `tests/test_distributed.py`
and larger meshes given as axis sizes).

One spawn of W = 4 gloo ranks as a 2 x 2 ("data", "model") mesh
(`launch/mesh.make_host_mesh(2)`; `run`, below) drives every routed
function; the parent rebuilds each rank's inputs (`inputs`) and composes
the reference's answer from its single-device functions (the reference's
own multi-device tests need an XLA subprocess of 8 host devices):

  * `route` / `send_back` over the world group, with and without drops:
    received blocks == the reference's `_pack` of each sender, rows back
    (+100 at the receiver) where kept, zeros where dropped; the gradient
    through `route` and `send_back`;
  * `moe_apply_a2a` over the model group (tokens split over the data
    axis, 4 experts a rank) == the reference's `moe_apply` on all tokens
    within 1e-5 (tests/test_perf_paths.py:106's config), its aux == the
    mean of the ranks' reference aux; `transformer._moe_shardmap` under
    `use_rules` (the mesh branch) the same, and without a mesh ==
    `moe_apply`;
  * `dlrm_lookup_a2a` on interleaved shards == the reference's
    `dlrm_lookup` exactly (tests/test_perf_paths.py:186's config);
  * `dlrm_sparse_update_sharded` == the reference's unsharded row-wise
    Adagrad on bf16-rounded gradients over the whole batch, each rank's
    shard: the same rows moved, values within 1e-6 (UPDATE);
  * `compressed_allreduce_mean` == the mean of the reference's
    `dequantize(quantize(g_r))` over the four ranks, exactly;
  * DimeNet's `loss_fn_sharded` (edges and triplets split four ways,
    triplets local to their rank) == the reference's whole-graph
    `loss_fn` within 1e-5 (tests/test_perf_paths.py:139), and its
    gradient summed over the ranks == `jax.grad` of that loss within
    1e-4, normwise.
"""
import dataclasses
import tempfile
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro import routing as jrt
from repro import sharding as jshard
from repro.data import recsys_stream as jstream
from repro.models import dimenet as jdn
from repro.models import moe as jmoe
from repro.models import recsys as jrs
from repro.train import compression as jz
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig

JOIN_TIMEOUT = 150.0
W, MODEL = 4, 2
ROUTE_N, ROUTE_D, BIG_CAP, SMALL_CAP = 40, 3, 64, 7
MOE = dict(d_model=32, n_experts=8, top_k=2, d_ff_expert=16, n_shared=1,
           norm_topk=True, capacity_factor=4.0, wire_capacity_factor=4.0)
MOE_TOKENS = 64
DLRM = dict(embed_dim=16, bot_mlp=(13, 32, 16), top_mlp=(64, 1),
            table_sizes=(20480,) * 3 + (60,))
DLRM_BATCH = 64
GRAD_N = 5000
GNN_NODES, GNN_EDGES = 64, 4 * 40
MOE_TOL = 1e-5
# the row-wise Adagrad: XLA sums a row's D squares in order, torch's
# vectorized mean in another, so a row's mean square is an ulp apart
UPDATE = 1e-6
GNN_FWD, GNN_GRAD = 1e-5, 1e-4


# --------------------------------------------------------------------------
# one rank (the spawned children import this module by name; `inputs`
# rebuilds a rank's inputs in the parent too)
# --------------------------------------------------------------------------

def _rng(tag: int) -> np.random.Generator:
    return np.random.default_rng(1000 + tag)


def moe_params() -> dict:
    r = _rng(1)
    e, d, f = MOE["n_experts"], MOE["d_model"], MOE["d_ff_expert"]
    n = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    return {"router": n(d, e), "gate": n(e, d, f) / 6, "up": n(e, d, f) / 6,
            "down": n(e, f, d) / 4,
            "shared": {"up": n(d, f) / 6, "gate": n(d, f) / 6,
                       "down": n(f, d) / 4}}


def dlrm_setup() -> dict:
    """Whole tables (natural row order), zero accumulators, the batch and a
    gradient for it."""
    r = _rng(2)
    rows = [v + (-v) % 512 if v >= 16_384 else v for v in DLRM["table_sizes"]]
    b = jstream.dlrm_batch(0, 0, 1, global_batch=DLRM_BATCH,
                           table_sizes=list(DLRM["table_sizes"]))
    return {"tables": {f"t{i}": r.normal(size=(n, 16)).astype(np.float32)
                       for i, n in enumerate(rows)},
            "accs": {f"t{i}": {"acc": r.uniform(0, 1, n).astype(np.float32)}
                     for i, n in enumerate(rows)},
            "sparse": b["sparse"],
            "g_emb": r.normal(size=(DLRM_BATCH, 4, 16)).astype(np.float32)}


def gnn_setup() -> dict:
    """tests/test_perf_paths.py:139's graph on W shards: edges split into
    W contiguous blocks, up to 2 triplets an edge from its own block."""
    r = _rng(3)
    cfg = gnn_cfg()
    src = r.integers(0, GNN_NODES, GNN_EDGES).astype(np.int32)
    dst = r.integers(0, GNN_NODES, GNN_EDGES).astype(np.int32)
    e_loc = GNN_EDGES // W
    kj_l, ji_l, mask_l = [], [], []
    for s in range(W):
        lo = s * e_loc
        for j in range(e_loc):
            ji = lo + j
            cands = [x for x in range(lo, lo + e_loc)
                     if dst[x] == src[ji] and src[x] != dst[ji]][:2]
            for c in cands + [lo] * (2 - len(cands)):
                kj_l.append(c)
                ji_l.append(ji)
                mask_l.append(1.0 if c in cands else 0.0)
    from repro_torch.models import dimenet as tdn
    from repro_torch.models.params import flatten, unflatten
    hot = {k: (r.normal(size=p.shape) / np.sqrt(p.shape[-2])).astype(
        np.float32) for k, p in flatten(tdn.param_specs(cfg)).items()}
    # the init's zero output heads (the reference test's parameters), and
    # nonzero heads: every leaf then has a gradient
    init = dict(hot, **{"blocks/out_w2": np.zeros_like(hot["blocks/out_w2"])})
    return {"params": unflatten(init), "params_hot": unflatten(hot),
            "src": src, "dst": dst,
            "kj": np.array(kj_l, np.int32), "ji": np.array(ji_l, np.int32),
            "t_mask": np.array(mask_l, np.float32),
            "pos": r.normal(size=(GNN_NODES, 3)).astype(np.float32),
            "x_feat": r.normal(size=(GNN_NODES, 8)).astype(np.float32),
            "label": r.integers(0, 5, GNN_NODES).astype(np.int32)}


def gnn_cfg(cls=None):
    from repro_torch.models import dimenet as tdn
    cls = cls or tdn.DimeNetConfig
    return cls(n_blocks=2, d_hidden=32, d_feat=8, n_targets=5,
               readout="node")


def inputs(rank: int) -> dict:
    """Rank `rank`'s own inputs (data rank rank // MODEL)."""
    r = np.random.default_rng(7 * rank + 1)
    return {"vals": r.normal(size=(ROUTE_N, ROUTE_D)).astype(np.float32),
            "dest": r.integers(0, W, ROUTE_N).astype(np.int64),
            "w": r.normal(size=(ROUTE_N, ROUTE_D)).astype(np.float32),
            "grad": r.normal(size=(GRAD_N,)).astype(np.float32)
            * (10.0 ** (rank - 2))}


def _data_slice(rank: int, n: int) -> slice:
    d, per = rank // MODEL, n // (W // MODEL)
    return slice(d * per, (d + 1) * per)


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import routing, sharding
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import dimenet as tdn
    from repro_torch.models import moe as tmoe
    from repro_torch.models import recsys as trs
    from repro_torch.models import transformer as ttf
    from repro_torch.models.params import flatten, unflatten
    from repro_torch.train import compression as tz
    from repro_torch.train.optimizer import OptimizerConfig

    torch.set_num_threads(1)
    mesh_lib.init_group(world, rank, backend="gloo", init_file=init_file)
    mesh = mesh_lib.make_host_mesh(MODEL)
    inp = inputs(rank)
    res = {"coords": np.array([mesh.get_local_rank("data"),
                               mesh.get_local_rank("model")])}
    t = torch.from_numpy

    # route / send_back over the world group, with and without drops
    for cap in (BIG_CAP, SMALL_CAP):
        x = t(inp["vals"]).requires_grad_()
        recv, rt = routing.route({"x": x, "i": t(inp["dest"])},
                                 t(inp["dest"]), cap)
        back = routing.send_back(recv["x"] * float(rank + 1) + 100.0 *
                                 rt.recv_valid[:, None].float(), rt)
        (back * t(inp["w"])).sum().backward()
        res[f"recv/{cap}"] = recv["x"].detach().numpy()
        res[f"recv_i/{cap}"] = recv["i"].numpy()
        res[f"valid/{cap}"] = rt.recv_valid.numpy()
        res[f"back/{cap}"] = back.detach().numpy()
        res[f"kept/{cap}"] = rt.kept.numpy()
        res[f"grad/{cap}"] = x.grad.numpy()

    # MoE over the model group, tokens split over the data axis
    cfg = tmoe.MoEConfig(**MOE)
    pm = params_from_numpy(moe_params(), "cpu")
    e_loc = cfg.n_experts // MODEL
    lo = mesh.get_local_rank("model") * e_loc
    p_loc = {k: v[lo:lo + e_loc] if k in ("gate", "up", "down") else v
             for k, v in pm.items()}
    xm = t(np.random.default_rng(5).normal(size=(MOE_TOKENS, 32)).astype(
        np.float32)[_data_slice(rank, MOE_TOKENS)])
    y, aux = tmoe.moe_apply_a2a(p_loc, xm, cfg, group=mesh.get_group("model"),
                                mean_group=dist.group.WORLD)
    res["moe_y"], res["moe_aux"] = y.numpy(), aux.numpy()
    lm = types.SimpleNamespace(moe=dataclasses.replace(cfg, impl="a2a"))
    h = xm.reshape(2, -1, 32)
    with sharding.use_rules(sharding.LM_RULES, mesh):
        ys, auxs = ttf._moe_shardmap(pm, h, lm)
    res["moe_mesh_y"], res["moe_mesh_aux"] = ys.numpy(), auxs.numpy()
    yp, _ = ttf._moe_shardmap(pm, h, lm)
    res["moe_plain_y"] = yp.numpy()

    # DLRM: routed lookup and the sharded row-wise Adagrad
    dcfg = trs.DLRMConfig(**DLRM)
    ds = dlrm_setup()
    m_rank = mesh.get_local_rank("model")
    tables = trs.interleave_shard(params_from_numpy(ds["tables"], "cpu"),
                                  dcfg, m_rank, MODEL)
    accs = trs.interleave_shard(params_from_numpy(ds["accs"], "cpu"), dcfg,
                                m_rank, MODEL)
    sl = _data_slice(rank, DLRM_BATCH)
    ids = t(ds["sparse"][sl])
    res["lookup"] = trs.dlrm_lookup_a2a(tables, ids, dcfg, mesh).numpy()
    trs.dlrm_sparse_update_sharded(tables, accs, ids, t(ds["g_emb"][sl]),
                                   dcfg, OptimizerConfig(table_lr=0.1), mesh)
    for k in tables:
        res[f"table/{k}"] = tables[k].numpy()
        res[f"acc/{k}"] = accs[k]["acc"].numpy()

    # int8 all-reduce over the world group
    res["allreduce"] = tz.compressed_allreduce_mean(t(inp["grad"])).numpy()

    # DimeNet local triplets: this rank's edge block, world-group SUM
    g = gnn_setup()
    e_loc = GNN_EDGES // W
    batch = {k: t(v) for k, v in _gnn_batch(
        g, slice(rank * e_loc, (rank + 1) * e_loc),
        slice(rank * 2 * e_loc, (rank + 1) * 2 * e_loc), e_loc).items()}
    loss, _ = tdn.loss_fn_sharded(params_from_numpy(g["params"], "cpu"),
                                  batch, gnn_cfg())
    res["gnn_loss"] = loss.detach().numpy()
    leaves = {k: v.requires_grad_() for k, v in flatten(
        params_from_numpy(g["params_hot"], "cpu")).items()}
    loss, _ = tdn.loss_fn_sharded(unflatten(leaves), batch, gnn_cfg())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    res["gnn_loss_hot"] = loss.detach().numpy()
    for k, v in zip(leaves, grads):
        res[f"gnn_grad/{k}"] = v.numpy()
    with torch.no_grad():
        res["gnn_out"] = tdn.apply(unflatten(leaves), batch, gnn_cfg(),
                                   psum_group=dist.group.WORLD).numpy()
    dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **res)


# --------------------------------------------------------------------------
# the parent: the reference's compositions
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(run, args=(W, f"{tmp}/store", tmp),
                                 nprocs=W, join=False, start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"W={W} ranks still running after "
                                       f"{JOIN_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        return [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(W)]


def _rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---- one process -----------------------------------------------------------

@pytest.mark.parametrize("n,groups,cap", [(40, 4, 64), (40, 4, 7),
                                          (97, 5, 3), (16, 1, 16)])
def test_pack_group_and_ungroup_slot_for_slot(n, groups, cap):
    import torch
    from repro_torch import routing
    r = np.random.default_rng(n + groups + cap)
    dest = r.integers(0, groups, n).astype(np.int32)
    dest[: n // 3] = 0                       # a crowded group: drops
    vals = r.normal(size=(n, 3)).astype(np.float32)
    ids = r.integers(0, 1000, n).astype(np.int32)
    jp, jv, js, jk = jrt._pack({"x": jnp.asarray(vals), "i": jnp.asarray(ids)},
                               jnp.asarray(dest), groups, cap)
    tp, tv, ts, tk = routing._pack({"x": torch.from_numpy(vals),
                                    "i": torch.from_numpy(ids)},
                                   torch.from_numpy(dest), groups, cap)
    for key in ("x", "i"):
        assert np.array_equal(tp[key].numpy(), np.asarray(jp[key]))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert (~tk.numpy()).sum() == max(0, int(np.bincount(
        dest, minlength=groups).clip(cap, None).sum() - groups * cap))
    jg, jslot, _ = jrt.local_group_by({"x": jnp.asarray(vals)},
                                      jnp.asarray(dest), groups, cap)
    tg, tslot, _ = routing.local_group_by({"x": torch.from_numpy(vals)},
                                          torch.from_numpy(dest), groups, cap)
    assert np.array_equal(tg["x"].numpy(), np.asarray(jg["x"]))
    out = r.normal(size=(groups, cap, 3)).astype(np.float32)
    assert np.array_equal(
        routing.ungroup(torch.from_numpy(out), tslot, groups, cap).numpy(),
        np.asarray(jrt.ungroup(jnp.asarray(out), jslot, groups, cap)))


def _grads():
    r = np.random.default_rng(11)
    big = r.normal(size=(3, 5000)).astype(np.float32) * 1e3
    big[1] = 0.0                               # all-zero blocks
    half = (np.arange(4096, dtype=np.float32) - 2048) / 127 * 3.5  # ties
    return [r.normal(size=(7,)).astype(np.float32), big, half,
            r.standard_cauchy(size=(2, 2048)).astype(np.float32)]


@pytest.mark.parametrize("case", range(4))
def test_quantize_dequantize_feedback_bit_for_bit(case):
    import torch
    from repro_torch.train import compression as tz
    g = _grads()[case]
    res = np.random.default_rng(case).normal(size=g.shape).astype(np.float32)
    tq, ts, tn = tz.quantize(torch.from_numpy(g))
    jq, js, jn = jz.quantize(jnp.asarray(g))
    assert tn == jn and tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy().view(np.int32),
                          np.asarray(js).view(np.int32))
    assert np.array_equal(tz.dequantize(tq, ts, tn, g.shape).numpy(),
                          np.asarray(jz.dequantize(jq, js, jn, g.shape)))
    td, tr = tz.compress_with_feedback(torch.from_numpy(g),
                                       torch.from_numpy(res))
    jd, jr = jz.compress_with_feedback(jnp.asarray(g), jnp.asarray(res))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tr.numpy(), np.asarray(jr))


SPEC_CASES = [
    # tests/test_distributed.py:33-57
    (("batch", None, "act_embed"), "LM_RULES", {"data": 1, "model": 1}, None),
    (("batch",), "LM_RULES", {"data": 1, "model": 1}, None),
    (("vocab",), "LM_RULES", {"model": 1}, (50,)),
    (("edges",), "GNN_RULES", {"data": 1, "model": 1}, (512,)),
    # larger meshes: missing axes dropped, the divisible prefix kept
    (("batch", "act_seq", "act_embed"), "LM_RULES",
     {"pod": 2, "data": 16, "model": 16}, (256, 4096, 896)),
    (("edges",), "GNN_RULES", {"pod": 2, "data": 16, "model": 16}, (96,)),
    (("table_rows", None), "RECSYS_RULES", {"data": 4, "model": 8},
     (20480, 16)),
    (("kv_seq",), "LM_LONGCTX_RULES", {"data": 2, "model": 4}, (6,)),
    (("vocab", "embed"), "LM_DECODE_RULES", {"data": 2, "model": 4}, None),
    (None, "LM_RULES", {"data": 2}, None),
]


@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_rules_and_spec_for_match(case):
    from repro_torch import sharding
    axes, rules, sizes, shape = SPEC_CASES[case]
    for name in ("LM_RULES", "LM_DECODE_RULES", "LM_LONGCTX_RULES",
                 "RECSYS_RULES", "GNN_RULES"):
        assert getattr(sharding, name) == getattr(jshard, name)
    fake = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    # this jax's PartitionSpec stores a one-axis entry ("data",) as "data"
    want = tuple(e if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in jshard.spec_for(axes, getattr(jshard, rules), fake,
                                          shape))
    assert sharding.spec_for(axes, getattr(sharding, rules), sizes,
                             shape) == want
    with sharding.use_rules(sharding.GNN_RULES, sizes):
        assert sharding.current_ctx() == (sharding.GNN_RULES, sizes)
    assert sharding.current_ctx() is None


# ---- the W = 4 spawn --------------------------------------------------------

@pytest.mark.parametrize("cap", [BIG_CAP, SMALL_CAP])
def test_route_and_send_back_match(ranks, cap):
    packs = [jrt._pack({"x": jnp.asarray(inputs(s)["vals"]),
                        "i": jnp.asarray(inputs(s)["dest"])},
                       jnp.asarray(inputs(s)["dest"].astype(np.int32)), W, cap)
             for s in range(W)]
    for r in range(W):
        got = ranks[r]
        # block s of rank r's receive buffer: sender s's slots for rank r
        want_x = np.concatenate([np.asarray(p[0]["x"][r]) for p in packs])
        want_i = np.concatenate([np.asarray(p[0]["i"][r]) for p in packs])
        want_v = np.concatenate([np.asarray(p[1]).reshape(W, cap)[r]
                                 for p in packs])
        assert np.array_equal(got[f"recv/{cap}"], want_x)
        assert np.array_equal(got[f"recv_i/{cap}"], want_i)
        assert np.array_equal(got[f"valid/{cap}"], want_v)
        inp, kept = inputs(r), np.asarray(packs[r][3])
        assert np.array_equal(got[f"kept/{cap}"], kept)
        scale = (inp["dest"] + 1).astype(np.float32)[:, None]
        want_back = np.where(kept[:, None], inp["vals"] * scale + 100.0, 0.0)
        assert np.array_equal(got[f"back/{cap}"], want_back.astype(np.float32))
        assert np.array_equal(got[f"grad/{cap}"],
                              np.where(kept[:, None], inp["w"] * scale, 0.0))
    assert (cap == BIG_CAP) == all(ranks[r][f"kept/{cap}"].all()
                                   for r in range(W))


def test_moe_a2a_matches_moe_apply(ranks):
    cfg = jmoe.MoEConfig(**MOE)
    p = jax.tree_util.tree_map(jnp.asarray, moe_params())
    x = np.random.default_rng(5).normal(size=(MOE_TOKENS, 32)).astype(
        np.float32)
    moe_apply = jax.jit(jmoe.moe_apply, static_argnums=2)
    y_ref, _ = moe_apply(p, jnp.asarray(x), cfg)
    aux_ref = np.mean([float(moe_apply(p, jnp.asarray(
        x[_data_slice(r, MOE_TOKENS)]), cfg)[1]) for r in range(W)])
    for r in range(W):
        want = np.asarray(y_ref)[_data_slice(r, MOE_TOKENS)]
        got = ranks[r]
        assert float(np.abs(got["moe_y"] - want).max()) < MOE_TOL
        assert abs(float(got["moe_aux"]) - aux_ref) < MOE_TOL * aux_ref
        assert float(np.abs(got["moe_mesh_y"].reshape(-1, 32) - want).max()
                     ) < MOE_TOL
        assert float(got["moe_mesh_aux"]) == float(got["moe_aux"])
        assert float(np.abs(got["moe_plain_y"].reshape(-1, 32) - want).max()
                     ) < MOE_TOL


def test_dlrm_lookup_a2a_equals_take(ranks):
    cfg = jrs.DLRMConfig(**DLRM)
    ds = dlrm_setup()
    want = np.asarray(jrs.dlrm_lookup(
        jax.tree_util.tree_map(jnp.asarray, ds["tables"]),
        jnp.asarray(ds["sparse"]), cfg))
    for r in range(W):
        assert np.array_equal(ranks[r]["lookup"],
                              want[_data_slice(r, DLRM_BATCH)])


def test_sparse_update_sharded_matches_reference(ranks):
    """Against the reference's unsharded row-wise Adagrad
    (`dlrm_train_step_sparse`'s own branch, src/repro/models/recsys.py:305)
    over the whole batch on the bf16-rounded gradients."""
    ds = dlrm_setup()
    opt = JOptimizerConfig(table_lr=0.1)
    g_all = jnp.asarray(ds["g_emb"]).astype(jnp.bfloat16).astype(jnp.float32)
    new_t, new_a = {}, {}
    for i in range(len(DLRM["table_sizes"])):
        k = f"t{i}"
        t, acc = jnp.asarray(ds["tables"][k]), jnp.asarray(ds["accs"][k]["acc"])
        ids, g = jnp.asarray(ds["sparse"][:, i]), g_all[:, i]
        acc = acc.at[ids].add(jnp.mean(jnp.square(g), axis=-1))
        scale = opt.table_lr / jnp.sqrt(
            jnp.maximum(acc[ids] + opt.table_eps, 1e-30))
        new_t[k] = t.at[ids].add(-(scale[:, None] * g).astype(t.dtype))
        new_a[k] = {"acc": acc}
    moved = 0
    for r in range(W):
        m = r % MODEL
        for i, rows in enumerate(DLRM["table_sizes"]):
            k = f"t{i}"
            cut = (lambda a: a[m::MODEL]) if rows >= 16_384 else (
                lambda a: a)
            got, start = ranks[r][f"table/{k}"], cut(ds["tables"][k])
            want = cut(np.asarray(new_t[k]))
            assert np.array_equal((got != start).any(axis=1),
                                  (want != start).any(axis=1)), (r, k)
            assert _rel(got, want) <= UPDATE, (r, k)
            assert _rel(ranks[r][f"acc/{k}"],
                        cut(np.asarray(new_a[k]["acc"]))) <= UPDATE, (r, k)
            moved += int((got != start).any(axis=1).sum())
    assert moved > 0


def test_compressed_allreduce_mean_matches(ranks):
    deq = []
    for r in range(W):
        g = jnp.asarray(inputs(r)["grad"])
        deq.append(jz.dequantize(*jz.quantize(g), g.shape))
    want = np.asarray(jnp.mean(jnp.stack(deq), axis=0))
    for r in range(W):
        assert np.array_equal(ranks[r]["allreduce"], want)


def _gnn_batch(g, es=slice(None), ts=slice(None), local=None) -> dict:
    """The whole graph, or one rank's partition (edges `es`, triplets `ts`
    indexing its own `local` edges)."""
    e = len(g["src"][es])
    local = local or GNN_EDGES
    return {"pos": g["pos"], "x_feat": g["x_feat"],
            "edge_src": g["src"][es], "edge_dst": g["dst"][es],
            "edge_mask": np.ones(e, np.float32),
            "t_kj": g["kj"][ts] % local, "t_ji": g["ji"][ts] % local,
            "t_mask": g["t_mask"][ts], "label": g["label"],
            "label_mask": np.ones(GNN_NODES, np.float32)}


def test_dimenet_loss_fn_sharded_matches_whole_graph(ranks):
    """The reference test's parameters (zero output heads): the loss equals
    the whole graph's.  Nonzero heads: node_out equals the whole graph's
    (normwise), and the loss and the gradient summed over the ranks equal
    the reference's local-triplets semantics composed on one device (the
    SUM of `apply` over the four edge partitions, then the loss).  The
    whole-graph gradient itself is not the bound there: summing node_out
    in partitions reorders sums of terms up to 2e6 (self-loop edges put
    the envelope near 1e6), which moves the loss by 2.4e-5 and one leaf's
    gradient (blocks/w_msg1) by 0.099, as much in the reference's own
    `loss_fn_sharded` on four devices as here."""
    from repro_torch.models.params import flatten
    g = gnn_setup()
    cfg = gnn_cfg(jdn.DimeNetConfig)
    jb = jax.tree_util.tree_map(jnp.asarray, _gnn_batch(g))
    e_loc = GNN_EDGES // W
    parts = [jax.tree_util.tree_map(jnp.asarray, _gnn_batch(
        g, slice(r * e_loc, (r + 1) * e_loc),
        slice(r * 2 * e_loc, (r + 1) * 2 * e_loc), e_loc)) for r in range(W)]

    def sharded_loss(p):
        logits = sum(jdn.apply(p, b, cfg) for b in parts)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jb["label"][:, None], axis=-1)[:, 0]
        return nll.mean()

    @jax.jit
    def reference(p_init, p_hot):
        return (jdn.loss_fn(p_init, jb, cfg)[0], jdn.apply(p_hot, jb, cfg),
                jax.value_and_grad(sharded_loss)(p_hot))

    loss, out, (loss_hot, grads) = reference(
        *(jax.tree_util.tree_map(jnp.asarray, g[k])
          for k in ("params", "params_hot")))
    want = flatten(jax.tree_util.tree_map(np.asarray, grads))
    for r in range(W):
        assert _rel(ranks[r]["gnn_loss"], loss) <= GNN_FWD
        assert _rel(ranks[r]["gnn_out"], out) <= GNN_FWD
        assert _rel(ranks[r]["gnn_loss_hot"], loss_hot) <= GNN_FWD
    for k, v in want.items():
        got = sum(ranks[r][f"gnn_grad/{k}"] for r in range(W))
        assert _rel(got, v) <= GNN_GRAD, k
        # each rank holds its own part, not the whole gradient
        assert _rel(ranks[0][f"gnn_grad/{k}"], v) > GNN_GRAD, k
