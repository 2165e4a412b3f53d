"""The port's sequential recommenders (SASRec, BERT4Rec) against the JAX
package's (CPU).

Both packages get the same seeded numpy inputs, and the port starts from
the reference's weights, carried across with `convert.params_from_numpy`:

  * the encoder (`sasrec_encode`, causal and bidirectional) at both smoke
    configs;
  * `sasrec_loss` and `bert4rec_loss` with the same raw key (the
    negatives are `prng.randint`, BERT4Rec's mask `prng.uniform` of the
    split key, both bit for bit), and their gradients against
    `jax.grad`; `_sampled_softmax` with a logQ correction;
  * `score_candidates`, and `topk_over_catalog` at the smoke catalog and
    at 1,000,000 items with the reference's 65,536-id chunks, where the
    last chunk's 48,576 clamped slots all score item 999,999 alike: the
    duplicated item at the top, and distinct items with equal scores,
    whose order must be the lower id first as `jax.lax.top_k` gives;
  * both configs field for field.

Tolerances: ids, masks, negatives and configs are exact, and so are the
top-k ids.  Float32 results are held by their normwise relative error,
max |port - ref| / max |ref|: encodings, losses and scores to FWD = 1e-5
(measured below 1e-6), gradients to GRAD = 1e-4.  Top-k values are
scores of equal items and held to FWD too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert4rec as jbert_cfg
from repro.configs import registry as jreg
from repro.configs import sasrec as jsas_cfg
from repro.models import params as jparams
from repro.models import recsys as jrs
from repro_torch import convert
from repro_torch.configs import bert4rec as tbert_cfg
from repro_torch.configs import registry as treg
from repro_torch.configs import sasrec as tsas_cfg
from repro_torch.models import params as tparams
from repro_torch.models import recsys as trs

FWD = 1e-5
GRAD = 1e-4

CFGS = {"sasrec": (jsas_cfg, tsas_cfg), "bert4rec": (jbert_cfg, tbert_cfg)}


def rel_err(port, ref) -> float:
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(initial=0.0), 1e-30)
    return float(np.abs(port - ref).max(initial=0.0) / scale)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _setup(name, seed=0):
    jc = CFGS[name][0].SMOKE
    tc = CFGS[name][1].SMOKE
    jp = jparams.init_tree(jrs.sasrec_specs(jc), jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(seed + 1)
    batch = {"history": rng.integers(0, jc.n_items, (8, jc.seq_len)).astype(
        np.int32), "target": rng.integers(0, jc.n_items, 8).astype(np.int32)}
    return jc, tc, jp, convert.params_from_numpy(np_params, "cpu"), batch


@pytest.mark.parametrize("name", list(CFGS))
def test_configs_field_for_field(name):
    jmod, tmod = CFGS[name]
    for attr in ("CFG", "SMOKE"):
        assert (dataclasses.asdict(getattr(tmod, attr))
                == dataclasses.asdict(getattr(jmod, attr)))
        assert getattr(tmod, attr).pad_id == getattr(jmod, attr).pad_id
    t, j = treg.get(name), jreg.get(name)
    assert (t.family, t.shapes, t.skip_shapes, t.notes) == (
        j.family, j.shapes, j.skip_shapes, j.notes)
    assert (tparams.param_count(trs.sasrec_specs(t.cfg))
            == jparams.param_count(jrs.sasrec_specs(j.cfg)))


@pytest.mark.parametrize("name", list(CFGS))
def test_encode_matches(name):
    jc, tc, jp, tp, batch = _setup(name)
    want = jax.jit(lambda p, h: jrs.sasrec_encode(p, h, jc))(
        jp, batch["history"])
    got = trs.sasrec_encode(tp, _t(batch["history"]), tc)
    assert rel_err(got, want) <= FWD


@pytest.mark.parametrize("name", list(CFGS))
def test_loss_and_gradients_match(name):
    """The training loss with the same raw key, and every gradient."""
    jc, tc, jp, tp, batch = _setup(name)
    jloss_fn = jrs.sasrec_loss if name == "sasrec" else jrs.bert4rec_loss
    tloss_fn = trs.sasrec_loss if name == "sasrec" else trs.bert4rec_loss
    for seed in (0, 5):
        key = jax.random.PRNGKey(seed)
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jloss_fn(p, batch, jc, key), has_aux=True))(jp)
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in tparams.flatten(tp).items()}
        tl, tm = tloss_fn(tparams.unflatten(leaves),
                          {k: _t(v) for k, v in batch.items()}, tc,
                          np.asarray(key))
        assert rel_err(tl, jl) <= FWD and tm["ce"] is tl
        gs = torch.autograd.grad(tl, list(leaves.values()))
        jf = _jflat(jg)
        assert set(leaves) == set(jf)
        for k, g in zip(leaves, gs):
            assert rel_err(g, jf[k]) <= GRAD, (seed, k)


def test_sampled_softmax_with_logq():
    jc, tc, jp, tp, batch = _setup("sasrec", seed=3)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(8, jc.embed_dim)).astype(np.float32)
    logq = rng.normal(size=(8 + jc.n_neg,)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jrs._sampled_softmax(jp, h, batch["target"], key, jc,
                                logq=jnp.asarray(logq))
    got = trs._sampled_softmax(tp, _t(h), _t(batch["target"]),
                               np.asarray(key), tc, logq=_t(logq))
    assert rel_err(got, want) <= FWD


def test_score_candidates_matches():
    jc, tc, jp, tp, _ = _setup("bert4rec", seed=6)
    rng = np.random.default_rng(7)
    h = rng.normal(size=(5, jc.embed_dim)).astype(np.float32)
    cand = rng.integers(0, jc.n_items + 1, 300).astype(np.int32)
    want = jrs.score_candidates(jp, h, cand)
    got = trs.score_candidates(tp, _t(h), _t(cand))
    assert got.dtype == torch.float32 and rel_err(got, want) <= FWD


def _topk_both(items, h, jc, tc, k, chunk):
    jv, ji = jax.jit(lambda p, h: jrs.topk_over_catalog(
        p, h, jc, k=k, chunk=chunk))({"items": items}, h)
    tv, ti = trs.topk_over_catalog({"items": _t(items)}, _t(h), tc, k=k,
                                   chunk=chunk)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("case", ["random", "clamped_top", "equal_items"])
def test_topk_over_catalog_smoke(case):
    """500 items in 64-id chunks: the last chunk's 12 clamped slots score
    item 499; it leads ("clamped_top"), or items 17, 130, 250 and 499
    share one embedding at the top ("equal_items")."""
    jc, tc = jsas_cfg.SMOKE, tsas_cfg.SMOKE
    rng = np.random.default_rng(12)
    items = rng.normal(size=(jc.n_items + 1, jc.embed_dim)).astype(np.float32)
    h = rng.normal(size=(4, jc.embed_dim)).astype(np.float32)
    if case != "random":
        top = 10.0 * h.mean(0) / np.linalg.norm(h.mean(0))
        h = np.abs(h) * np.sign(h.mean(0))  # every user agrees with `top`
        items[499] = top
        if case == "equal_items":
            items[[17, 130, 250]] = top
    (jv, ji), (tv, ti) = _topk_both(items, h, jc, tc, k=20, chunk=64)
    np.testing.assert_array_equal(ti, ji)
    assert rel_err(tv, jv) <= FWD
    if case == "clamped_top":
        assert (ji[:, :13] == 499).all()  # item 499 and its 12 copies
    if case == "equal_items":
        assert (ji[:, :3] == [17, 130, 250]).all() and (ji[:, 3:16]
                                                      == 499).all()


@pytest.mark.parametrize("case", ["random", "clamped_top"])
def test_topk_over_catalog_full_catalog(case):
    """1,000,000 items in the reference's 65,536-id chunks (16 chunks, the
    last with 48,576 slots clamped to item 999,999), k = 100."""
    jc = dataclasses.replace(jsas_cfg.CFG, embed_dim=8)
    tc = dataclasses.replace(tsas_cfg.CFG, embed_dim=8)
    rng = np.random.default_rng(13)
    items = rng.normal(size=(jc.n_items + 1, 8)).astype(np.float32)
    h = rng.normal(size=(3, 8)).astype(np.float32)
    if case == "clamped_top":
        h = np.abs(h)
        items[999_999] = 6.0
        items[[5, 65_536]] = 6.0   # distinct items scoring the same
    (jv, ji), (tv, ti) = _topk_both(items, h, jc, tc, k=100, chunk=65_536)
    np.testing.assert_array_equal(ti, ji)
    assert rel_err(tv, jv) <= FWD
    if case == "clamped_top":
        assert (ji[:, :2] == [5, 65_536]).all() and (ji[:, 2:100]
                                                    == 999_999).all()
