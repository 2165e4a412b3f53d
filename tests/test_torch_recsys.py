"""The port's recommender path against the JAX package's (CPU).

Both packages get the same seeded numpy inputs, and the port starts from
the reference's weights, carried across with `convert.params_from_numpy`:

  * every function of `models/layers.py` and the helpers of
    `models/params.py` (spec shapes, counts, bytes, init rules);
  * `data/recsys_stream` and `data/pipeline`: the same arrays bit for bit;
  * the DLRM at the smoke config and at dlrm-mlperf's widths with 26
    64-row tables: forward, loss, every gradient and
    `dlrm_score_candidates`; two-tower loss with and without `item_logq`,
    its gradients and its scores;
  * the full and smoke configs field for field, and the registry;
  * an `AdmissionSpec`-gated 26-field batch: rows equal, then the DLRM on
    the gated rows.

Tolerances: ids, rows, batches and configs are exact.  Float32 results
are held by their normwise relative error, max |port - ref| / max |ref|:
each side sums its matrix products (K up to 1,024) and reductions in its
own order, which measured at most 1e-5 here (the dlrm-mlperf candidate
scores 9.6e-6), so forward passes, losses and gradients are held to
REL = 5e-5.  Single layers hold to 1e-6 (one rounding order apart).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_mlperf as jdlrm_cfg
from repro.configs import registry as jreg
from repro.configs import two_tower as jtt_cfg
from repro.core import CMLS16 as JCMLS16
from repro.core import SketchSpec as JSpec
from repro.core import admission as jadm
from repro.core import sketch as jsk
from repro.data import pipeline as jpipe
from repro.data import recsys_stream as jstream
from repro.models import layers as jl
from repro.models import params as jparams
from repro.models import recsys as jrs
from repro_torch import convert
from repro_torch.configs import dlrm_mlperf as tdlrm_cfg
from repro_torch.configs import registry as treg
from repro_torch.configs import two_tower as ttt_cfg
from repro_torch.core import CMLS16, SketchSpec, prng
from repro_torch.core import admission as tadm
from repro_torch.core import sketch as tsk
from repro_torch.data import pipeline as tpipe
from repro_torch.data import recsys_stream as tstream
from repro_torch.models import layers as tl
from repro_torch.models import params as tparams
from repro_torch.models import recsys as trs

REL = 5e-5      # normwise relative error of a model's float32 outputs
LAYER = 1e-6    # one layer


def rel_err(port, ref) -> float:
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(initial=0.0), 1e-30)
    return float(np.abs(port - ref).max(initial=0.0) / scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_cfg(jc, cls):
    return cls(**dataclasses.asdict(jc))


def _carried(jspecs, seed=0):
    """(reference params, the same weights as port CPU tensors)."""
    jp = jparams.init_tree(jspecs, jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _port_grads(loss_fn, params):
    leaves = {k: v.clone().requires_grad_()
              for k, v in tparams.flatten(params).items()}
    loss, _ = loss_fn(tparams.unflatten(leaves))
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


def _check_grads(tgrads, jgrads, tol=REL):
    jflat = _jflat(jgrads)
    assert set(tgrads) == set(jflat)
    for k, g in tgrads.items():
        assert rel_err(g, jflat[k]) <= tol, k


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm(unit_offset):
    x, s = _x((4, 7, 32)), _x((32,), 1)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(s), unit_offset=unit_offset)
    got = tl.rms_norm(_t(x), _t(s), unit_offset=unit_offset)
    assert rel_err(got, want) <= LAYER


def test_layer_norm():
    x, s, b = _x((5, 48), 0, 3.0), _x((48,), 1), _x((48,), 2)
    want = jl.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    assert rel_err(tl.layer_norm(_t(x), _t(s), _t(b)), want) <= LAYER


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    x, w, b = _x((6, 40)), _x((40, 24), 1), _x((24,), 2)
    jb, tb = (jnp.asarray(b), _t(b)) if bias else (None, None)
    want = jl.dense(jnp.asarray(x), jnp.asarray(w), jb)
    assert rel_err(tl.dense(_t(x), _t(w), tb), want) <= LAYER


@pytest.mark.parametrize("activation,gated", [("silu", True), ("gelu", True),
                                              ("relu", False)])
def test_mlp(activation, gated):
    jspecs = jl.mlp_specs(24, 40, gated=gated)
    tspecs = tl.mlp_specs(24, 40, gated=gated)
    assert ({k: (s.shape, s.axes) for k, s in tspecs.items()}
            == {k: (s.shape, s.axes) for k, s in jspecs.items()})
    jp, tp = _carried(jspecs)
    x = _x((3, 5, 24))
    want = jl.mlp_apply(jp, jnp.asarray(x), activation)
    assert rel_err(tl.mlp_apply(tp, _t(x), activation), want) <= LAYER


def test_rope():
    x = _x((2, 9, 3, 16))
    pos = np.tile(np.arange(9, dtype=np.int32) * 37, (2, 1))
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos))
    assert rel_err(tl.rope(_t(x), _t(pos)), want) <= LAYER


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap(cap):
    x = _x((64,), 0, 40.0)
    want = jl.softcap(jnp.asarray(x), cap)
    assert rel_err(tl.softcap(_t(x), cap), want) <= LAYER


def test_embed_lookup():
    table = _x((50, 8))
    ids = np.random.default_rng(1).integers(0, 50, (4, 6)).astype(np.int32)
    want = jl.embed_lookup(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(
        tl.embed_lookup(_t(table), _t(ids)).numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag(mode, weighted):
    rng = np.random.default_rng(3)
    table = _x((40, 12))
    ids = rng.integers(0, 40, (2, 5, 3)).astype(np.int32)
    w = rng.random((2, 5, 3)).astype(np.float32) if weighted else None
    want = jl.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode,
                            None if w is None else jnp.asarray(w))
    got = tl.embedding_bag(_t(table), _t(ids), mode,
                           None if w is None else _t(w))
    assert rel_err(got, want) <= LAYER
    with pytest.raises(ValueError):
        tl.embedding_bag(_t(table), _t(ids), "median")


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy(z_loss):
    logits = _x((3, 7, 50), 0, 4.0)
    tgt = np.random.default_rng(2).integers(0, 50, (3, 7)).astype(np.int32)
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt), z_loss)
    got = tl.cross_entropy(_t(logits), _t(tgt), z_loss)
    assert rel_err(got, want) <= LAYER


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def _shapes(specs):
    return {k: (tuple(s.shape), s.axes, s.init)
            for k, s in tparams.flatten(specs).items()}


def _jshapes(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jparams.P))[0]
    return {"/".join(str(k.key) for k in path): (tuple(s.shape), s.axes,
                                                 s.init)
            for path, s in leaves}


@pytest.mark.parametrize("which", ["dlrm", "dlrm_smoke", "two_tower",
                                   "two_tower_smoke"])
def test_specs_counts_and_bytes(which):
    jmod, tmod = {"dlrm": (jdlrm_cfg, tdlrm_cfg),
                  "dlrm_smoke": (jdlrm_cfg, tdlrm_cfg),
                  "two_tower": (jtt_cfg, ttt_cfg),
                  "two_tower_smoke": (jtt_cfg, ttt_cfg)}[which]
    attr = "SMOKE" if which.endswith("smoke") else "CFG"
    jc, tc_ = getattr(jmod, attr), getattr(tmod, attr)
    if which.startswith("dlrm"):
        jspecs, tspecs = jrs.dlrm_specs(jc), trs.dlrm_specs(tc_)
    else:
        jspecs, tspecs = jrs.twotower_specs(jc), trs.twotower_specs(tc_)
    assert _shapes(tspecs) == _jshapes(jspecs)
    assert tparams.param_count(tspecs) == jparams.param_count(jspecs)
    assert tparams.param_bytes(tspecs) == jparams.param_bytes(jspecs)


def test_full_width_sizes():
    c = tdlrm_cfg.CFG
    specs = trs.dlrm_specs(c)
    dense = {k: v for k, v in specs.items() if k != "tables"}
    assert tparams.param_count(dense) == 2_368_897
    assert c.interact_dim == 479
    gated = dataclasses.replace(c, table_sizes=(1024 + (1 << 20),) * 26)
    assert tparams.param_bytes(trs.dlrm_specs(gated)["tables"]) \
        == 13_972_275_200
    tt = trs.twotower_specs(ttt_cfg.CFG)
    assert tt["user_table"].shape == (5_000_192, 256)
    assert tt["item_table"].shape == (1_000_448, 256)
    assert tparams.param_bytes({"u": tt["user_table"],
                                "i": tt["item_table"]}) == 6_144_655_360


def test_init_tree_rules_and_order():
    specs = {"z": tparams.P((3, 4), init="zeros"),
             "o": tparams.P((5,), init="ones"),
             "n": tparams.P((200, 300), init="normal:0.01"),
             "e": tparams.P((300, 200), init="embed"),
             "l": tparams.P((8, 25, 200))}
    a = tparams.init_tree(specs, 7, "cpu")
    b = tparams.init_tree(specs, torch.Generator().manual_seed(7), "cpu")
    assert list(tparams.flatten(a)) == ["e", "l", "n", "o", "z"]
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
    assert torch.equal(a["z"], torch.zeros(3, 4))
    assert torch.equal(a["o"], torch.ones(5))
    assert float(a["n"].std()) == pytest.approx(0.01, rel=0.02)
    assert float(a["e"].std()) == pytest.approx(1.0, rel=0.02)
    assert float(a["l"].std()) == pytest.approx(1 / math.sqrt(200), rel=0.02)
    assert not torch.equal(tparams.init_tree(specs, 8, "cpu")["n"], a["n"])
    with pytest.raises(ValueError, match="rank"):
        tparams.P((3, 4), axes=("a",))


def test_flatten_unflatten_paths():
    tree = {"tables": {"t10": 1, "t2": 2}, "bot": {"w0": 3}}
    flat = tparams.flatten(tree)
    assert list(flat) == ["bot/w0", "tables/t10", "tables/t2"]
    assert tparams.unflatten(flat) == tree
    assert list(_jflat(tree)) == list(flat)


# --------------------------------------------------------------------------
# data: recsys streams and the pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 1, 2),
                                                 (123, 3, 4)])
def test_recsys_streams_bit_equal(step, shard, n_shards):
    kw = dict(global_batch=64, seed=5)
    pairs = [
        (jstream.dlrm_batch, tstream.dlrm_batch,
         dict(table_sizes=jrs.criteo_tables())),
        (jstream.seq_batch, tstream.seq_batch,
         dict(n_items=1000, seq_len=12)),
        (jstream.twotower_batch, tstream.twotower_batch,
         dict(n_users=5000, n_items=1000)),
    ]
    for jf, tf, extra in pairs:
        want = jf(step, shard, n_shards, **kw, **extra)
        got = tf(step, shard, n_shards, **kw, **extra)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_token_batch_source_and_prefetcher_bit_equal():
    tokens = np.random.default_rng(0).integers(0, 1000, 5000).astype(
        np.int32)
    jsrc = jpipe.token_batch_source(tokens, global_batch=8, seq_len=16,
                                    seed=3)
    tsrc = tpipe.token_batch_source(tokens, global_batch=8, seq_len=16,
                                    seed=3)
    for step, shard, n in [(0, 0, 1), (5, 1, 2), (9, 3, 4)]:
        want, got = jsrc.batch(step, shard, n), tsrc.batch(step, shard, n)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    src = tpipe.BatchSource(
        lambda s, sh, n: tstream.dlrm_batch(s, sh, n, global_batch=16,
                                            table_sizes=[100] * 3))
    pf = tpipe.Prefetcher(src, 0, 1, start_step=4, depth=2)
    try:
        it = iter(pf)
        for want_step in range(4, 8):
            step, batch = next(it)
            assert step == want_step
            np.testing.assert_array_equal(
                batch["sparse"], tstream.dlrm_batch(
                    step, 0, 1, global_batch=16,
                    table_sizes=[100] * 3)["sparse"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_configs_field_for_field_and_registry():
    for jmod, tmod in ((jdlrm_cfg, tdlrm_cfg), (jtt_cfg, ttt_cfg)):
        for attr in ("CFG", "SMOKE"):
            assert (dataclasses.asdict(getattr(tmod, attr))
                    == dataclasses.asdict(getattr(jmod, attr)))
    archs = treg.load_all()
    # every reference arch
    assert set(archs) == set(jreg.load_all())
    for name in ("dlrm-mlperf", "two-tower-retrieval"):
        t, j = treg.get(name), jreg.get(name)
        assert (t.family, t.shapes, t.skip_shapes, t.notes) \
            == (j.family, j.shapes, j.skip_shapes, j.notes)
        assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert treg.get("dlrm_mlperf") is archs["dlrm-mlperf"]
    assert trs.criteo_tables() == jrs.criteo_tables()
    assert trs.criteo_tables(1000) == jrs.criteo_tables(1000)
    for n in (1, 511, 512, 513, 16_383, 16_384, 40_000_000):
        assert trs.round_rows(n) == jrs.round_rows(n)
        t, j = trs.table_spec(n, 8), jrs.table_spec(n, 8)
        assert (t.shape, t.axes, t.init) == (j.shape, j.axes, j.init)


# --------------------------------------------------------------------------
# DLRM
# --------------------------------------------------------------------------

DLRM_CFGS = {
    "smoke": jdlrm_cfg.SMOKE,
    "mlperf_widths": dataclasses.replace(jdlrm_cfg.CFG,
                                         table_sizes=(64,) * 26),
}


def _dlrm_case(name, batch=64):
    jc = DLRM_CFGS[name]
    tc_ = _port_cfg(jc, trs.DLRMConfig)
    jp, tp = _carried(jrs.dlrm_specs(jc))
    b = jstream.dlrm_batch(0, 0, 1, global_batch=batch,
                           table_sizes=list(jc.table_sizes))
    return (jc, tc_, jp, tp, {k: jnp.asarray(v) for k, v in b.items()},
            {k: _t(v) for k, v in b.items()})


@pytest.mark.parametrize("name", list(DLRM_CFGS))
def test_dlrm_forward_loss_and_grads(name):
    jc, tc_, jp, tp, jb, tb = _dlrm_case(name)
    want = jrs.dlrm_apply(jp, jb, jc)
    got = trs.dlrm_apply(tp, tb, tc_)
    assert got.shape == (64,) and rel_err(got, want) <= REL
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jrs.dlrm_loss(p, jb, jc), has_aux=True))(jp)
    tloss, tg = _port_grads(lambda p: trs.dlrm_loss(p, tb, tc_), tp)
    assert rel_err(tloss, jloss) <= REL
    _check_grads(tg, jg)
    # the embedding gradients are rows of the looked-up ids only
    touched = np.unique(np.asarray(jb["sparse"][:, 3]))
    untouched = np.setdiff1d(np.arange(64), touched)
    assert not tg["tables/t3"][untouched].any()


@pytest.mark.parametrize("name", list(DLRM_CFGS))
@pytest.mark.parametrize("cand_field", [0, 7])
def test_dlrm_score_candidates(name, cand_field):
    jc, tc_, jp, tp, jb, tb = _dlrm_case(name, batch=4)
    cands = np.random.default_rng(1).integers(0, 10**6, 300).astype(np.int32)
    want = jax.jit(jrs.dlrm_score_candidates, static_argnums=(3, 4))(
        jp, jb, jnp.asarray(cands), jc, cand_field)
    got = trs.dlrm_score_candidates(tp, tb, _t(cands), tc_, cand_field)
    assert got.shape == (300,) and rel_err(got, want) <= REL


def test_dlrm_lookup_and_pairs():
    jc, tc_, jp, tp, jb, tb = _dlrm_case("smoke", batch=8)
    np.testing.assert_array_equal(
        trs.dlrm_lookup(tp["tables"], tb["sparse"], tc_).numpy(),
        np.asarray(jrs.dlrm_lookup(jp["tables"], jb["sparse"], jc)))
    for n in (2, 5, 27):   # the interaction's pair order
        iu, ju = torch.triu_indices(n, n, 1)
        jiu, jju = jnp.triu_indices(n, k=1)
        np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
        np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))


def test_bce_matches():
    logit = _x((256,), 0, 20.0)
    y = (np.random.default_rng(1).random(256) < 0.5).astype(np.float32)
    assert rel_err(trs._bce(_t(logit), _t(y)),
                   jrs._bce(jnp.asarray(logit), jnp.asarray(y))) <= LAYER


def test_admission_gated_batch_rows_equal_then_dlrm():
    """A 26-field batch through observe_and_admit in both packages (one
    sketch counting every field, as the example does): sketch, rows and
    masks exact, then the DLRM on the gated rows."""
    spec = JSpec.from_memory(64 * 1024, depth=2, counter=JCMLS16)
    tspec = SketchSpec.from_memory(64 * 1024, depth=2, counter=CMLS16)
    jaspec = jadm.AdmissionSpec(threshold=3.0, n_fallback=32, table_rows=96)
    taspec = tadm.AdmissionSpec(threshold=3.0, n_fallback=32, table_rows=96)
    jc = dataclasses.replace(jdlrm_cfg.SMOKE, table_sizes=(128,) * 26)
    tc_ = _port_cfg(jc, trs.DLRMConfig)
    js, ts = jsk.init(spec), tsk.init(tspec, device="cpu")
    jkey, tkey = jax.random.PRNGKey(1), np.array([0, 1], np.uint32)
    jp, tp = _carried(jrs.dlrm_specs(jc))
    for step in range(3):
        b = jstream.dlrm_batch(step, 0, 1, global_batch=128,
                               table_sizes=jrs.criteo_tables())
        flat = b["sparse"].reshape(-1).astype(np.uint32)
        jkey, jk = jax.random.split(jkey)
        tkey, tk = prng.split(tkey, 2)
        js, jrows, jadmit = jadm.observe_and_admit(js, jnp.asarray(flat), jk,
                                                   jaspec)
        ts, trows, tadmit = tadm.observe_and_admit(ts, _t(flat), tk, taspec)
        np.testing.assert_array_equal(
            tsk.query_state(ts, _t(flat)).numpy(),
            np.asarray(jsk.query_state(js, jnp.asarray(flat))))
        np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
        np.testing.assert_array_equal(tadmit.numpy(), np.asarray(jadmit))
    assert 0 < int(tadmit.sum()) < flat.size
    sparse = trows.reshape(128, 26)
    want = jrs.dlrm_apply(jp, {"dense": jnp.asarray(b["dense"]),
                               "sparse": jrows.reshape(128, 26)}, jc)
    got = trs.dlrm_apply(tp, {"dense": _t(b["dense"]), "sparse": sparse},
                         tc_)
    assert rel_err(got, want) <= REL


# --------------------------------------------------------------------------
# two-tower
# --------------------------------------------------------------------------

def _tt_case(batch=16):
    jc = jtt_cfg.SMOKE
    tc_ = _port_cfg(jc, trs.TwoTowerConfig)
    jp, tp = _carried(jrs.twotower_specs(jc))
    b = jstream.twotower_batch(0, 0, 1, global_batch=batch,
                               n_users=jc.n_users, n_items=jc.n_items)
    return (jc, tc_, jp, tp, {k: jnp.asarray(v) for k, v in b.items()},
            {k: _t(v) for k, v in b.items()})


@pytest.mark.parametrize("logq", [False, True], ids=["plain", "logq"])
def test_twotower_loss_and_grads(logq):
    jc, tc_, jp, tp, jb, tb = _tt_case()
    if logq:
        q = np.log(np.random.default_rng(4).random(16) * 0.01 + 1e-4)
        jb["item_logq"] = jnp.asarray(q.astype(np.float32))
        tb["item_logq"] = _t(q.astype(np.float32))
    ju, jv = jrs.twotower_embed(jp, jb, jc)
    tu, tv = trs.twotower_embed(tp, tb, tc_)
    assert rel_err(tu, ju) <= REL and rel_err(tv, jv) <= REL
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jrs.twotower_loss(p, jb, jc), has_aux=True))(jp)
    tloss, tg = _port_grads(lambda p: trs.twotower_loss(p, tb, tc_), tp)
    assert rel_err(tloss, jloss) <= REL
    _check_grads(tg, jg)


def test_twotower_score_candidates():
    jc, tc_, jp, tp, jb, tb = _tt_case(batch=3)
    cands = np.random.default_rng(2).integers(
        0, jc.n_items, (500, jc.n_item_feats)).astype(np.int32)
    want = jrs.twotower_score_candidates(jp, jb, jnp.asarray(cands), jc)
    got = trs.twotower_score_candidates(tp, tb, _t(cands), tc_)
    assert got.shape == (3, 500) and rel_err(got, want) <= REL


def test_sketch_logq_tracks_item_frequencies():
    """The composition `tests/test_system.py` checks for the reference:
    log(estimate / events) of a CMLS16 sketch over the item stream."""
    items = (np.random.default_rng(0).zipf(1.5, 50_000) % 1000).astype(
        np.uint32)
    spec = SketchSpec.from_memory(1 << 18, 2, CMLS16)
    s = tsk.update(tsk.init(spec, device="cpu"), _t(items),
                   np.array([0, 0], np.uint32), mode="batched")
    ids, counts = np.unique(items, return_counts=True)
    sel = counts >= 20
    est = tsk.query(s, _t(ids[sel])).numpy()
    err = np.abs(np.log(est / len(items)) - np.log(counts[sel] / len(items)))
    assert err.mean() < 0.15
