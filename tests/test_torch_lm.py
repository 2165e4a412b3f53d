"""The port's LM scaffold against the JAX package's (CPU).

Both packages get the same seeded numpy inputs, and the port starts from
the reference's weights, carried across with `convert.params_from_numpy`
(the parameter and cache trees have the same leaf paths and layouts):

  * `core/prng.randint` against `jax.random.randint`, bit for bit;
  * `models/attention.py`: `attend` in the four mask kinds, full, with
    `chunk_q` and with `kv_chunk`, softcap on and off, GQA groups of 1
    and 2 (outputs and gradients); `gqa_apply` with a cache whose local
    slot wraps and a chunked layer's clamped write; `mla_prefill` and
    `mla_decode`;
  * `models/moe.py`: `moe_apply` with and without dropped tokens, tied
    router probabilities, `norm_topk` and shared experts (outputs, aux,
    gradients);
  * `models/transformer.py` at every registered LM smoke config: `apply`
    logits and aux, `loss_fn` and its gradients against `jax.grad`,
    `prefill`'s cache leaf for leaf, four teacher-forced `decode_step`s
    (a local layer's slot wraps, a chunked layer's write clamps);
    `init_cache`; the three remat policies; `active_param_count`,
    `model_flops` and `param_count` of every full config; every full and
    smoke config field for field;
  * five `make_train_step` steps of the qwen2 smoke config from a
    carried-across `TrainState`;
  * `launch/train.main --sketch` in-process, its sketch against the
    reference's `update_batched` over the same `token_batch_source`
    batches with keys (0, step); `launch/serve.main`'s prompt and
    tokens teacher-forced through the reference's prefill / decode.

Tolerances: random ints, configs, counts, cache positions and argmax
tokens are exact.  Float32 results are held by their normwise relative
error, max |port - ref| / max |ref|: XLA's CPU dot and torch's sum in
different orders, measured at most 1.9e-6 here, so logits, losses and
caches are held to FWD = 1e-5, and gradients and the AdamW moments
after five steps to GRAD = 1e-4.  The parameters after those steps are
held to ADAM_PARAMS = 1e-3: Adam divides each element's first moment by
its own root mean square, so an element whose gradient is 1e-5 of its
leaf's largest takes a full-size step carrying its gradient's relative
rounding (0.24% measured on the qwen2 smoke config's key bias, whose
gradient nearly cancels under the softmax's shift invariance: 5.0e-4
normwise after five steps; every other leaf within 3.5e-6).  The sketch's CMLS16 cells may land one
state apart on at most 1e-4 of them (`nfold` runs float32 expm1 / log1p
of two libraries); CMS32 cells are exact.
"""
import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import CMLS16 as JCMLS16
from repro.core import CMS32 as JCMS32
from repro.core import SketchSpec as JSpec
from repro.core import sketch as jsk
from repro.core.hashing import combine2 as jcombine2
from repro.data import corpus as jcorpus
from repro.data import pipeline as jpipe
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.models import transformer as jtf
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.core import CMS32, SketchSpec, prng
from repro_torch.core import sketch as tsk
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttf
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

FWD = 1e-5      # logits, losses, attention outputs, caches
GRAD = 1e-4     # gradients, states after five train steps
ADAM_PARAMS = 1e-3  # parameters after five AdamW steps (see below)
NFOLD = 1e-4    # CMLS16 cells one state apart, at most this share

LM_NAMES = ["qwen2-0.5b", "phi3-mini-3.8b", "gemma2-27b",
            "llama4-scout-17b-a16e", "deepseek-v2-lite-16b"]


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
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_trees(port_tree, ref_tree, tol):
    tflat = tparams.flatten(port_tree)
    jflat = _jflat(ref_tree)
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        if v.is_floating_point():
            assert rel_err(v, jflat[k]) <= tol, k
        else:
            np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)


def _grads(loss_fn, params):
    """(loss, aux dict, gradient tree) of a port loss over `params`."""
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in tparams.flatten(params).items()}
    loss, metrics = loss_fn(tparams.unflatten(leaves))
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, metrics, tparams.unflatten(
        {k: torch.zeros_like(v) if g is None else g
         for (k, v), g in zip(leaves.items(), gs)})


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


def _fields(cfg) -> dict:
    """A config's fields, nested configs expanded, dtypes by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif f.name == "dtype":
            v = _dtype_name(v)
        out[f.name] = v
    return out


# --------------------------------------------------------------------------
# prng.randint
# --------------------------------------------------------------------------

@pytest.mark.parametrize("span", [(0, 1_000_000), (0, 151_936), (0, 1),
                                  (-7, 999_983), (0, 65_536), (0, 65_537),
                                  (5, 5), (0, 2**31 - 1)],
                         ids=lambda s: f"{s[0]}_{s[1]}")
def test_randint_bit_for_bit(span):
    lo, hi = span
    for seed in (0, 1, 2, 77, 2**31 - 1):
        for shape in ((1,), (16,), (3, 7)):
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                                 shape, lo, hi))
            got = prng.randint((0, seed), shape, lo, hi)
            assert got.dtype == torch.int32 and got.shape == shape
            np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _qkv(rng, b, sq, sk, h, n, d, dv=None):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, n, d), f(b, sk, n, dv or d)


_KINDS = {"global": {}, "local": {"window": 5}, "chunked": {"attn_chunk": 4},
          "bidir": {}}


@pytest.mark.parametrize("path", ["full", "chunk_q", "kv_chunk"])
@pytest.mark.parametrize("kind", list(_KINDS))
def test_attend_matches(kind, path):
    """Outputs and the gradients of a weighted sum w.r.t. q, k and v: MHA
    without a softcap, then GQA groups of 2 with one."""
    rng = np.random.default_rng(3)
    pos = np.arange(16, dtype=np.int32)
    for cap, h, n in ((None, 4, 4), (2.0, 4, 2)):
        q, k, v = _qkv(rng, 2, 16, 16, h, n, 8)
        w = rng.normal(size=(2, 16, h, 8)).astype(np.float32)
        kw = dict(kind=kind, scale=8 ** -0.5, cap=cap, **_KINDS[kind])
        if path != "full":
            kw[path] = 4

        def jf(q, k, v):
            o = jattn.attend(q, k, v, pos, pos, **kw)
            return jnp.sum(o * w), o

        (_, jo), jg = jax.jit(jax.value_and_grad(
            jf, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        to = tattn.attend(tq, tk, tv, _t(pos), _t(pos), **kw)
        tg = torch.autograd.grad((to * _t(w)).sum(), (tq, tk, tv))
        assert rel_err(to, jo) <= FWD, (cap, h, n)
        for a, b in zip(tg, jg):
            assert rel_err(a, b) <= GRAD, (cap, h, n)


@pytest.mark.parametrize("kind,slot_pos", [("local", 10), ("global", 6),
                                           ("chunked", 12)])
def test_gqa_apply_with_cache(kind, slot_pos):
    """A decode step into an 8-slot cache: the local layer's slot wraps
    (position 10 -> slot 2); the chunked layer writes position 12 to the
    last slot (the reference's clamped dynamic_update_slice)."""
    rng = np.random.default_rng(5)
    c = jattn.GQAConfig(d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
                        qkv_bias=True, attn_softcap=20.0)
    tc = tattn.GQAConfig(**dataclasses.asdict(c))
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32) * 0.3,
        jattn.gqa_specs(c), is_leaf=lambda s: isinstance(s, jparams.P))
    cache = {"k": rng.normal(size=(2, 8, 2, 8)).astype(np.float32),
             "v": rng.normal(size=(2, 8, 2, 8)).astype(np.float32),
             "pos": np.array([8, 9, -1, 3, 4, 5, 6, 7], np.int32)}
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    positions = np.array([slot_pos], np.int32)
    kw = dict(kind=kind, window=6, attn_chunk=4)
    jy, jc = jax.jit(lambda p, x, cache: jattn.gqa_apply(
        p, x, positions, c, cache=cache, **kw))(params, x, cache)
    ty, tcache = tattn.gqa_apply(convert.params_from_numpy(params, "cpu"),
                                 _t(x), _t(positions), tc,
                                 cache=convert.params_from_numpy(cache, "cpu"),
                                 **kw)
    assert rel_err(ty, jy) <= FWD
    _close_trees(tcache, jc, FWD)
    # the input cache is left as it was
    np.testing.assert_array_equal(cache["pos"],
                                  [8, 9, -1, 3, 4, 5, 6, 7])


def test_mla_prefill_and_decode():
    rng = np.random.default_rng(6)
    c = jattn.MLAConfig(d_model=32, n_heads=4, kv_lora=16, qk_nope=8,
                        qk_rope=4, v_dim=8)
    tc = tattn.MLAConfig(**dataclasses.asdict(c))
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32) * 0.3,
        jattn.mla_specs(c), is_leaf=lambda s: isinstance(s, jparams.P))
    tp = convert.params_from_numpy(params, "cpu")
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    for kw in ({}, {"chunk_q": 4}, {"kv_chunk": 4}):
        jy, jc = jax.jit(lambda p, x: jattn.mla_prefill(
            p, x, pos, c, want_cache=True, **kw))(params, x)
        ty, tcache = tattn.mla_prefill(tp, _t(x), _t(pos), tc,
                                       want_cache=True, **kw)
        assert rel_err(ty, jy) <= FWD, kw
        _close_trees(tcache, jc, FWD)
    cache = {"ckv": np.zeros((2, 16, 16), np.float32),
             "kr": np.zeros((2, 16, 4), np.float32),
             "pos": np.full((16,), -1, np.int32)}
    cache["ckv"][:, :12] = np.asarray(jc["ckv"])
    cache["kr"][:, :12] = np.asarray(jc["kr"])
    cache["pos"][:12] = pos
    tcache = convert.params_from_numpy(cache, "cpu")
    jdecode = jax.jit(lambda p, x, pos, cache: jattn.mla_decode(
        p, x, pos, c, cache))
    for p in (12, 13, 20):  # 20 clamps to the last slot
        xd = rng.normal(size=(2, 1, 32)).astype(np.float32)
        jy, cache = jdecode(params, xd, np.array([p], np.int32), cache)
        ty, tcache = tattn.mla_decode(tp, _t(xd), torch.tensor([p]).int(),
                                      tc, tcache)
        assert rel_err(ty, jy) <= FWD, p
        _close_trees(tcache, cache, FWD)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

_MOE_CASES = {
    "top1_shared": dict(n_experts=4, top_k=1, d_ff_expert=16, n_shared=1,
                        d_ff_shared=16),
    "top2_norm_2shared": dict(n_experts=8, top_k=2, d_ff_expert=16,
                              n_shared=2, norm_topk=True),
    "drops": dict(n_experts=4, top_k=2, d_ff_expert=16,
                  capacity_factor=0.25),
    "tied_router": dict(n_experts=8, top_k=3, d_ff_expert=16),
}


@pytest.mark.parametrize("case", list(_MOE_CASES))
def test_moe_apply_matches(case):
    rng = np.random.default_rng(8)
    c = jmoe.MoEConfig(d_model=16, **_MOE_CASES[case])
    tc = tmoe.MoEConfig(**dataclasses.asdict(c))
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32) * 0.3,
        jmoe.moe_specs(c), is_leaf=lambda s: isinstance(s, jparams.P))
    if case == "tied_router":
        # experts 0-3 get the same router column: equal probabilities, so
        # the lower expert index must win every tie, as in jax.lax.top_k
        params["router"][:, 1:4] = params["router"][:, :1]
    x = rng.normal(size=(40, 16)).astype(np.float32)
    if case == "drops":
        cap = jmoe.capacity(c, 40)
        assert tmoe.capacity(tc, 40) == cap == 8
        _, idx = jax.lax.top_k(jax.nn.softmax(x @ params["router"]), 2)
        assert np.bincount(np.asarray(idx).ravel()).max() > cap

    def jf(p, x):
        y, aux = jmoe.moe_apply(p, x, c)
        return jnp.sum(y * x) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(params, x)
    leaves = {k: v.requires_grad_() for k, v in tparams.flatten(
        convert.params_from_numpy(params, "cpu")).items()}
    tx = _t(x).requires_grad_()
    ty, taux = tmoe.moe_apply(tparams.unflatten(leaves), tx, tc)
    gx, *gp = torch.autograd.grad((ty * tx).sum() + taux,
                                  [tx] + list(leaves.values()))
    assert rel_err(ty, jy) <= FWD and rel_err(taux, jaux) <= FWD
    assert rel_err(gx, jgx) <= GRAD
    _close_trees(tparams.unflatten(dict(zip(leaves, gp))), jgp, GRAD)


# --------------------------------------------------------------------------
# the decoder at every LM smoke config
# --------------------------------------------------------------------------

PROMPT = 12     # prefill length; then four decode steps to MAX_LEN
MAX_LEN = 16


@pytest.fixture(scope="module", params=LM_NAMES)
def lm(request):
    """The reference's results at one smoke config, and the port's."""
    name = request.param
    jc = jreg.get(name).smoke_cfg
    tc = treg.get(name).smoke_cfg
    jp = jparams.init_tree(jtf.param_specs(jc), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (2, MAX_LEN)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}

    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, batch, jc), has_aux=True))(jp)
    jlogits, _ = jax.jit(lambda p: jtf.apply(p, batch["tokens"], jc))(jp)
    jlast, jcache = jax.jit(lambda p, t: jtf.prefill(
        p, t, jc, max_len=MAX_LEN))(jp, toks[:, :PROMPT])
    jdecode = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, c, t, pos, jc))
    jdec, cache = [], jcache
    for pos in range(PROMPT, MAX_LEN):
        d, cache = jdecode(jp, cache, toks[:, pos:pos + 1],
                           jnp.asarray(pos, jnp.int32))
        jdec.append(np.asarray(d))
    ref = dict(loss=jl, ce=jm["ce"], aux=jm["aux"], logits=jlogits, grads=jg,
               last=jlast, cache=jcache, decode=jdec, decode_cache=cache)

    tp = convert.params_from_numpy(np_params, "cpu")
    tbatch = {k: _t(v) for k, v in batch.items()}
    tl, tm, tg = _grads(lambda p: ttf.loss_fn(p, tbatch, tc), tp)
    with torch.no_grad():
        tlogits, taux = ttf.apply(tp, tbatch["tokens"], tc)
        tlast, tcache = ttf.prefill(tp, tbatch["tokens"][:, :PROMPT], tc,
                                    max_len=MAX_LEN)
        tdec, cache = [], tcache
        for pos in range(PROMPT, MAX_LEN):
            d, cache = ttf.decode_step(
                tp, cache, tbatch["tokens"][:, pos:pos + 1],
                torch.tensor(pos, dtype=torch.int32), tc)
            tdec.append(d)
    port = dict(loss=tl, ce=tm["ce"], aux=tm["aux"], logits=tlogits,
                aux_apply=taux, grads=tg, last=tlast, cache=tcache,
                decode=tdec, decode_cache=cache)
    return dict(name=name, jc=jc, tc=tc, ref=ref, port=port, tp=tp,
                batch=tbatch)


def test_lm_apply_logits_and_aux(lm):
    r, p = lm["ref"], lm["port"]
    assert p["logits"].dtype == torch.float32
    assert rel_err(p["logits"], r["logits"]) <= FWD
    assert rel_err(p["aux_apply"], r["aux"]) <= FWD


def test_lm_loss_and_gradients(lm):
    r, p = lm["ref"], lm["port"]
    for k in ("loss", "ce", "aux"):
        assert rel_err(p[k], r[k]) <= FWD, k
    _close_trees(p["grads"], r["grads"], GRAD)


def test_lm_prefill_cache_leaf_for_leaf(lm):
    r, p = lm["ref"], lm["port"]
    assert rel_err(p["last"], r["last"]) <= FWD
    _close_trees(p["cache"], r["cache"], FWD)


def test_lm_decode_steps(lm):
    """Four teacher-forced steps from the prefilled cache; with the smoke
    configs' 8-slot local and chunked caches, slots wrap and clamp."""
    r, p = lm["ref"], lm["port"]
    for got, want in zip(p["decode"], r["decode"]):
        assert rel_err(got, want) <= FWD
    _close_trees(p["decode_cache"], r["decode_cache"], FWD)


def test_lm_init_cache(lm):
    want = jtf.init_cache(lm["jc"], 3, 10)
    got = ttf.init_cache(lm["tc"], 3, 10, device="cpu")
    jf, tf_ = _jflat(want), tparams.flatten(got)
    assert set(jf) == set(tf_)
    for k, v in tf_.items():
        assert _dtype_name(v.dtype) == jf[k].dtype.name, k
        np.testing.assert_array_equal(v.float().numpy(),
                                      jf[k].astype(np.float32), err_msg=k)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "deepseek-v2-lite-16b"])
def test_remat_policies_agree(name):
    """"full", "dots" and "none" give the same loss and gradients."""
    base = treg.get(name).smoke_cfg
    params = tparams.init_tree(ttf.param_specs(base), 3, device="cpu")
    toks = _t(np.random.default_rng(2).integers(
        0, base.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    out = {}
    for policy in ("full", "dots", "none"):
        cfg = dataclasses.replace(base, remat=policy)
        out[policy] = _grads(lambda p: ttf.loss_fn(p, batch, cfg), params)
    for policy in ("dots", "none"):
        assert torch.equal(out[policy][0], out["full"][0]), policy
        for k, g in tparams.flatten(out[policy][2]).items():
            assert torch.equal(g, tparams.flatten(out["full"][2])[k]), k


def test_moe_impl_a2a_without_a_mesh_runs_moe_apply():
    """`impl="a2a"` outside a mesh: the reference's `_moe_shardmap` runs
    `moe_apply`, and so does the port; logits and aux equal the
    reference's at the llama4-scout smoke config."""
    jbase = jreg.get("llama4-scout-17b-a16e").smoke_cfg
    tbase = treg.get("llama4-scout-17b-a16e").smoke_cfg
    jc = dataclasses.replace(jbase, moe=dataclasses.replace(jbase.moe,
                                                            impl="a2a"))
    tc = dataclasses.replace(tbase, moe=dataclasses.replace(tbase.moe,
                                                            impl="a2a"))
    jp = jparams.init_tree(jtf.param_specs(jc), jax.random.PRNGKey(5))
    toks = np.random.default_rng(6).integers(0, jc.vocab_size,
                                             (2, 16)).astype(np.int32)
    jlogits, jaux = jax.jit(lambda p: jtf.apply(p, toks, jc))(jp)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    with torch.no_grad():
        tlogits, taux = ttf.apply(tp, _t(toks), tc)
        glogits, gaux = ttf.apply(tp, _t(toks), tbase)
    assert rel_err(tlogits, jlogits) <= FWD and rel_err(taux, jaux) <= FWD
    assert torch.equal(tlogits, glogits) and torch.equal(taux, gaux)


# --------------------------------------------------------------------------
# configs and accounting
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", LM_NAMES)
def test_lm_configs_field_for_field(name):
    j, t = jreg.get(name), treg.get(name)
    assert (t.family, t.shapes, t.skip_shapes, t.notes) == (
        j.family, j.shapes, j.skip_shapes, j.notes)
    assert _fields(t.cfg) == _fields(j.cfg)
    assert _fields(t.smoke_cfg) == _fields(j.smoke_cfg)
    assert t.cfg.n_groups == j.cfg.n_groups


@pytest.mark.parametrize("name", LM_NAMES)
def test_param_counts_and_model_flops(name):
    jc, tc = jreg.get(name).cfg, treg.get(name).cfg
    assert (tparams.param_count(ttf.param_specs(tc))
            == jparams.param_count(jtf.param_specs(jc)))
    assert (tparams.param_bytes(ttf.param_specs(tc))
            == jparams.param_bytes(jtf.param_specs(jc)))
    assert ttf.active_param_count(tc) == jtf.active_param_count(jc)
    for n_tok, seq in ((1, 1), (4096 * 256, 4096), (128, 32768)):
        assert ttf.model_flops(tc, n_tok, seq) == jtf.model_flops(jc, n_tok,
                                                                  seq)
    tspecs = tparams.flatten(ttf.cache_specs(tc, 2, 4096))
    jspecs = {"/".join(str(k.key) for k in p): s for p, s in
              jax.tree_util.tree_flatten_with_path(
                  jtf.cache_specs(jc, 2, 4096),
                  is_leaf=lambda s: isinstance(s, jparams.P))[0]}
    assert {k: (s.shape, s.axes, s.init) for k, s in tspecs.items()} == {
        k: (s.shape, s.axes, s.init) for k, s in jspecs.items()}


# --------------------------------------------------------------------------
# training and the launchers
# --------------------------------------------------------------------------

def test_five_train_steps_match_reference():
    jc = jreg.get("qwen2-0.5b").smoke_cfg
    tc = treg.get("qwen2-0.5b").smoke_cfg
    ocfg = topt.OptimizerConfig(peak_lr=2e-3, warmup_steps=2, decay_steps=5)
    jinit, jstep = jloop.make_train_step(
        lambda p, b, r: jtf.loss_fn(p, b, jc),
        jopt.OptimizerConfig(**dataclasses.asdict(ocfg)))
    _, tstep = tloop.make_train_step(
        lambda p, b, r: ttf.loss_fn(p, b, tc), ocfg)
    jstate = jinit(jparams.init_tree(jtf.param_specs(jc),
                                     jax.random.PRNGKey(0)),
                   jax.random.PRNGKey(1))
    tstate = convert.train_state_from_numpy(
        {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
         "opt_state": jax.tree_util.tree_map(np.asarray, jstate.opt_state),
         "step": np.asarray(jstate.step), "rng": np.asarray(jstate.rng)},
        "cpu")
    tokens = np.random.default_rng(4).integers(
        0, jc.vocab_size, 4096).astype(np.int32)
    src = tpipe.token_batch_source(tokens, 4, 16, seed=0)
    jit_step = jax.jit(jstep)
    for step in range(5):
        b = src.batch(step, 0, 1)
        jstate, jm = jit_step(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in b.items()})
        assert rel_err(tm["loss"], jm["loss"]) <= FWD, step
    _close_trees(tstate.opt_state, jstate.opt_state, GRAD)
    _close_trees(tstate.params, jstate.params, ADAM_PARAMS)
    np.testing.assert_array_equal(tstate.rng, np.asarray(jstate.rng))


def _ref_sketch(spec, steps, batch, seq, seed=0):
    """The reference's --sketch counting: update_batched over the same
    token_batch_source batches (steps 0..steps: the source runs one step
    ahead of the loop) with PRNGKey(step)."""
    tokens = jcorpus.generate(jcorpus.CorpusSpec(n_tokens=2_000_000))
    src = jpipe.token_batch_source(tokens, batch, seq, seed)
    s = jsk.init(spec)
    upd = jax.jit(jsk.update_batched)
    for step in range(steps + 1):
        flat = jnp.asarray(src.batch(step, 0, 1)["tokens"].reshape(-1),
                           jnp.uint32)
        keys = jnp.concatenate([flat, jcombine2(flat[:-1], flat[1:])])
        s = upd(s, keys, jax.random.PRNGKey(step))
    return tokens, src, s


def test_launch_train_sketch_matches_reference(capsys):
    state, sketch = ttrain.main(["--arch", "qwen2-0.5b", "--steps", "3",
                                 "--batch", "2", "--seq", "16", "--sketch",
                                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert int(state.step) == 3 and "[train] done at step 3" in out
    spec = JSpec.from_memory(1 << 20, depth=2, counter=JCMLS16)
    tokens, _, ref = _ref_sketch(spec, 3, 2, 16)
    want = np.asarray(ref.table)
    got = sketch.table.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    apart = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert apart.max() <= 1 and (apart > 0).mean() <= NFOLD
    # the printed estimates are the reference's sketch's, rounded
    top = np.argsort(-np.bincount(tokens[:100_000], minlength=50))[:8]
    est = np.asarray(jsk.query(ref, jnp.asarray(top.astype(np.uint32))))
    line = [ln for ln in out.splitlines() if "sketch estimates" in ln][0]
    printed = ast.literal_eval(line.split(": ", 1)[1])
    assert list(printed) == [int(t) for t in top]
    assert all(abs(printed[int(t)] - float(e)) <= 0.5 + 1e-3
               for t, e in zip(top, est))


def test_sketch_keys_count_exactly_in_cms32():
    """The --sketch keys and update on a CMS32 sketch: exact cells."""
    tokens = np.random.default_rng(9).integers(0, 5_000, 20_000).astype(
        np.uint32)
    src = jpipe.token_batch_source(tokens, 4, 32, 1)
    js = jsk.init(JSpec.from_memory(1 << 16, depth=2, counter=JCMS32))
    ts = tsk.init(SketchSpec.from_memory(1 << 16, depth=2, counter=CMS32),
                  device="cpu")
    upd = jax.jit(jsk.update_batched)
    for step in range(3):
        b = src.batch(step, 0, 1)["tokens"]
        flat = jnp.asarray(b.reshape(-1), jnp.uint32)
        js = upd(js, jnp.concatenate(
            [flat, jcombine2(flat[:-1], flat[1:])]),
            jax.random.PRNGKey(step))
        ts = tsk.update_batched(ts, ttrain.sketch_keys(b, "cpu"),
                                np.array([0, step], np.uint32))
    np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table))


def test_launch_serve_teacher_forced(capsys):
    """serve.main's prompt is the reference's randint bit for bit, and its
    greedy tokens are the reference prefill / decode's argmax when fed the
    same tokens and the port's weights."""
    params, prompt, toks = tserve.main(["--batch", "2", "--prompt-len", "8",
                                        "--gen", "6", "--seed", "3",
                                        "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] qwen2-0.5b (smoke cfg): prefill 8 tok")
    assert out[1] == "[serve] sample: " + str(toks[0, :16].tolist())
    want_prompt = jax.random.randint(jax.random.PRNGKey(4), (2, 8), 0, 512)
    np.testing.assert_array_equal(prompt.numpy(), np.asarray(want_prompt))
    jc = jreg.get("qwen2-0.5b").smoke_cfg
    jp = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(params))
    logits, cache = jtf.prefill(jp, jnp.asarray(prompt.numpy()), jc,
                                max_len=14)
    t = toks.numpy()
    np.testing.assert_array_equal(np.argmax(np.asarray(logits), -1), t[:, 0])
    for i in range(5):
        logits, cache = jtf.decode_step(jp, cache, jnp.asarray(t[:, i:i + 1]),
                                        jnp.asarray(8 + i, jnp.int32), jc)
        np.testing.assert_array_equal(np.argmax(np.asarray(logits), -1),
                                      t[:, i + 1])


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_gradient(z_loss):
    """`layers.cross_entropy`'s one-tensor backward against `jax.grad` of
    the reference's, and bit for bit against autograd of the plain
    logsumexp / gather composition it replaces."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(21)
    logits = (3 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    tgt = rng.integers(0, 50, (3, 7)).astype(np.int32)
    jg = jax.grad(lambda x: jl.cross_entropy(x, tgt, z_loss))(logits)
    x = _t(logits).requires_grad_()
    (g,) = torch.autograd.grad(tl.cross_entropy(x, _t(tgt), z_loss), (x,))
    assert rel_err(g, jg) <= GRAD

    def plain(x):
        lse = torch.logsumexp(x, dim=-1)
        ll = torch.gather(x, -1, _t(tgt)[..., None].long())[..., 0]
        loss = (lse - ll).mean()
        return loss + z_loss * lse.square().mean() if z_loss else loss

    y = _t(logits).requires_grad_()
    (want,) = torch.autograd.grad(plain(y), (y,))
    assert torch.equal(g, want)
