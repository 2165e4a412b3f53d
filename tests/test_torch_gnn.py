"""The port's graph path against the JAX package's (CPU): `data/graph.py`,
`models/dimenet.py` and `configs/dimenet.py`.

Both packages get the same seeded numpy inputs, and the port starts from
the reference's weights, carried across with `convert.params_from_numpy`:

  * `synthetic_graph`, `sample_neighbors`, `subgraph_sizes`,
    `build_triplets` and `batched_molecules`: the same arrays bit for
    bit for the same seed and `np.random.Generator` (isolated nodes,
    self-loops and padding included);
  * `bessel_roots` root for root, `_envelope` and `_legendre` bit for
    bit, `radial_basis` within RBF_ULPS, `_j_l` and `spherical_basis`
    within the bounds below;
  * `param_specs` shape for shape, `model_flops` against the reference's
    `launch/cells._gnn_model_flops` on the four `GNN_SHAPES` regimes;
  * `apply`, `loss_fn` and every gradient against `jax.value_and_grad` of
    the reference's `loss_fn`: the molecule and node-classification smoke
    cases of `tests/test_models_smoke.py:90,111`, and the full config's
    widths (6 blocks, d 128, 8 bilinear, 7 x 6 bases) on small graphs in
    both readouts;
  * the configs field for field and the registry entry.

Tolerances.  torch's and XLA's CPU float32 sin / cos differ by an ulp on
some arguments (`_envelope`, `_legendre` and the products around them
are the same expressions, bit for bit).  `radial_basis` is one sin away:
RBF_ULPS = 4 (2 measured).  `_j_l` runs the upward recurrence for
x >= 1, which multiplies those ulps by the growth of the second-kind
solution: normwise over x in [0, 40], measured 1.2e-7 (l = 0) up to
4.9e-3 (l = 6), held to 4x that (J_REL).  `spherical_basis` multiplies
by the envelope and P_l: each column within SBF_REL = 1e-4 of its
largest entry (1.3e-5 measured).  The model outputs and losses are held
normwise to FWD = 1e-5 and every gradient to GRAD = 1e-4 (the graph
readout sums node outputs that cancel: 5.3e-6 measured on the full
config's molecules, and its gradients 2.1e-5; the other cases within
1.1e-6 and 1.9e-6).  The output heads (`out_w2`, zeros at init) are drawn nonzero
so that every leaf has a gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet as jcfg
from repro.configs import registry as jreg
from repro.data import graph as jg
from repro.launch import cells as jcells
from repro.models import dimenet as jdn
from repro_torch import convert
from repro_torch.configs import dimenet as tcfg
from repro_torch.configs import registry as treg
from repro_torch.data import graph as tg
from repro_torch.models import dimenet as tdn
from repro_torch.models import params as tparams

RBF_ULPS = 4
J_REL = (5e-7, 2e-6, 4e-6, 2.5e-5, 2e-4, 2e-3, 2e-2)
SBF_REL = 1e-4
FWD = 1e-5
GRAD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small graphs: one intra-op thread runs them in a tenth of the time
    eight contending ones take."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _ulps(port, ref) -> int:
    a = np.asarray(port, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(ref, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _equal_arrays(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --------------------------------------------------------------------------
# data/graph.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,e,seed,power", [(64, 256, 1, 1.5),
                                            (1000, 20_000, 7, 1.5),
                                            (5000, 3000, 3, 1.1)])
def test_synthetic_graph_bit_for_bit(n, e, seed, power):
    a, b = tg.synthetic_graph(n, e, seed, power), jg.synthetic_graph(
        n, e, seed, power)
    _equal_arrays((a.indptr, a.indices), (b.indptr, b.indices))
    assert a.n_nodes == b.n_nodes and a.n_edges == b.n_edges == e


@pytest.mark.parametrize("fanouts", [[15, 10], [5, 3, 2]])
def test_sampler_and_triplets_bit_for_bit(fanouts):
    # 5,000 nodes and 3,000 edges: many isolated nodes (edge_mask False)
    tgraph, jgraph = (m.synthetic_graph(5000, 3000, 3) for m in (tg, jg))
    seeds = np.random.default_rng(0).choice(5000, 64, replace=False)
    t = tg.sample_neighbors(tgraph, seeds, fanouts, np.random.default_rng(1))
    j = jg.sample_neighbors(jgraph, seeds, fanouts, np.random.default_rng(1))
    _equal_arrays(t, j)
    assert not t[3].all()
    assert tg.subgraph_sizes(64, fanouts) == jg.subgraph_sizes(64, fanouts) \
        == (t[0].size, t[1].size)
    nodes, src, dst, _ = t
    for ang in (1, 4):
        _equal_arrays(
            tg.build_triplets(src, dst, nodes.size, ang,
                              np.random.default_rng(2)),
            jg.build_triplets(src, dst, nodes.size, ang,
                              np.random.default_rng(2)))


def test_molecules_and_whole_graph_triplets_bit_for_bit():
    for args in ((4, 12, 24, 0), (128, 30, 64, 5)):
        t, j = tg.batched_molecules(*args), jg.batched_molecules(*args)
        assert t.keys() == j.keys() and t["n_graphs"] == j["n_graphs"]
        _equal_arrays([t[k] for k in t if k != "n_graphs"],
                      [j[k] for k in j if k != "n_graphs"])
    g = tg.synthetic_graph(64, 256, seed=1)     # self-loops among them
    src = g.indices.astype(np.int32)
    dst = np.repeat(np.arange(64), np.diff(g.indptr)).astype(np.int32)
    assert (src == dst).any()
    _equal_arrays(tg.build_triplets(src, dst, 64, 3, np.random.default_rng(1)),
                  jg.build_triplets(src, dst, 64, 3, np.random.default_rng(1)))


# --------------------------------------------------------------------------
# the bases
# --------------------------------------------------------------------------

def test_bessel_roots_equal():
    for ns, nr in ((7, 6), (3, 4), (8, 9)):
        assert tdn.bessel_roots(ns, nr) == jdn.bessel_roots(ns, nr)
    x = np.linspace(0.0, 30.0, 1001)
    for l in range(7):
        assert np.array_equal(tdn._j_l_np(l, x), jdn._j_l_np(l, x),
                              equal_nan=True)


def test_envelope_legendre_and_radial_basis():
    rng = np.random.default_rng(0)
    r = np.concatenate([[0.0, 1e-6, 1e-3, 0.5, 4.999, 5.0, 6.0],
                        rng.uniform(0, 6, 4000)]).astype(np.float32)
    c = rng.uniform(-1, 1, r.size).astype(np.float32)
    for p in (6, 5):
        assert _ulps(tdn._envelope(torch.from_numpy(r), 5.0, p),
                     jdn._envelope(jnp.asarray(r), 5.0, p)) == 0
    for l in range(7):
        assert _ulps(tdn._legendre(l, torch.from_numpy(c)),
                     jdn._legendre(l, jnp.asarray(c))) == 0
    for cfg in (jcfg.CFG, jcfg.SMOKE):
        assert _ulps(tdn.radial_basis(torch.from_numpy(r), cfg),
                     jdn.radial_basis(jnp.asarray(r), cfg)) <= RBF_ULPS


def test_spherical_bessel_and_basis():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(0, 3, 5000),
                        rng.uniform(3, 40, 5000)]).astype(np.float32)
    for l in range(7):
        assert _rel(tdn._j_l(l, torch.from_numpy(x)),
                    jdn._j_l_jnp(l, jnp.asarray(x))) <= J_REL[l], l
    r = rng.uniform(0, 6, 5000).astype(np.float32)
    r[:2] = [1e-6, 0.0]
    c = rng.uniform(-1, 1, r.size).astype(np.float32)
    for cfg in (jcfg.CFG, jcfg.SMOKE):
        got = tdn.spherical_basis(torch.from_numpy(r), torch.from_numpy(c),
                                  cfg).numpy()
        want = np.asarray(jdn.spherical_basis(jnp.asarray(r), jnp.asarray(c),
                                              cfg))
        assert got.shape == want.shape == (r.size, cfg.n_spherical
                                           * cfg.n_radial)
        for col in range(want.shape[1]):
            assert _rel(got[:, col], want[:, col]) <= SBF_REL, col


# --------------------------------------------------------------------------
# params, FLOPs, configs
# --------------------------------------------------------------------------

def test_param_specs_flops_and_configs():
    for cfg in (tcfg.CFG, tcfg.SMOKE,
                dataclasses.replace(tcfg.CFG, d_feat=602, n_targets=41,
                                    readout="node")):
        jc = jdn.DimeNetConfig(**dataclasses.asdict(cfg))
        tf = tparams.flatten(tdn.param_specs(cfg))
        jf = tparams.flatten(jdn.param_specs(jc))
        assert tf.keys() == jf.keys()
        for k, s in tf.items():
            assert (s.shape, s.axes, s.init) == (jf[k].shape, jf[k].axes,
                                                 jf[k].init), k
    # (nodes, padded edges, triplets, d_feat) of the four regimes
    for n, e, t, f in ((3_840, 8_192, 65_536, None),
                       (2_708, 10_752, 86_016, 1_433),
                       (169_984, 168_960, 675_840, 602),
                       (2_449_029, 61_859_328, 123_718_656, 100)):
        assert tdn.model_flops(tcfg.CFG, n, e, t, f) == \
            jcells._gnn_model_flops(jcfg.CFG, n, e, t, f)
    for attr in ("CFG", "SMOKE"):
        assert (dataclasses.asdict(getattr(tcfg, attr))
                == dataclasses.asdict(getattr(jcfg, attr)))
    t, j = treg.get("dimenet"), jreg.get("dimenet")
    assert (t.family, t.shapes, t.skip_shapes, t.notes) == (
        j.family, j.shapes, j.skip_shapes, j.notes)
    assert t.cfg is tcfg.CFG and t.smoke_cfg is tcfg.SMOKE


# --------------------------------------------------------------------------
# apply, loss_fn and gradients
# --------------------------------------------------------------------------

def _molecule_case(cfg):
    """tests/test_models_smoke.py:90's batch, with a regression target."""
    m = jg.batched_molecules(4, 12, 24, seed=0)
    kj, ji, valid = jg.build_triplets(m["edge_src"], m["edge_dst"], 48, 4,
                                      np.random.default_rng(0))
    return {"pos": m["pos"], "atom_z": m["atom_z"],
            "edge_src": m["edge_src"], "edge_dst": m["edge_dst"],
            "edge_mask": np.ones((96,), np.float32),
            "t_kj": kj, "t_ji": ji, "t_mask": valid.astype(np.float32),
            "graph_id": m["graph_id"], "n_graphs": 4,
            "target": np.random.default_rng(5).normal(size=4).astype(
                np.float32)}


def _node_case(cfg, n=64, e=256, ang=3):
    """tests/test_models_smoke.py:111's graph (the last 10 edges padded
    out), with a label mask."""
    g = jg.synthetic_graph(n, e, seed=1)
    rng = np.random.default_rng(1)
    src = g.indices.astype(np.int32)
    dst = np.repeat(np.arange(n), np.diff(g.indptr)).astype(np.int32)
    kj, ji, valid = jg.build_triplets(src, dst, n, ang, rng)
    return {"pos": rng.normal(size=(n, 3)).astype(np.float32),
            "x_feat": rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
            "edge_src": src, "edge_dst": dst,
            "edge_mask": (np.arange(e) < e - 10).astype(np.float32),
            "t_kj": kj, "t_ji": ji, "t_mask": valid.astype(np.float32),
            "label": rng.integers(0, cfg.n_targets, n).astype(np.int32),
            "label_mask": (rng.random(n) < 0.8).astype(np.float32)}


SMOKE = jreg.get("dimenet").smoke_cfg
FULL = jreg.get("dimenet").cfg
CASES = {
    "smoke_molecule": (dataclasses.replace(SMOKE, readout="graph"),
                       _molecule_case),
    "smoke_node": (dataclasses.replace(SMOKE, readout="node", d_feat=8,
                                       n_targets=5), _node_case),
    "full_node": (dataclasses.replace(FULL, readout="node", d_feat=16,
                                      n_targets=7),
                  lambda c: _node_case(c, 128, 512, 8)),
    "full_molecule": (dataclasses.replace(FULL, readout="graph"),
                      _molecule_case),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_loss_and_gradients_match(case):
    jc, make = CASES[case]
    batch = make(jc)
    params = jdn.param_specs(jc)
    rng = np.random.default_rng(len(case))
    p_np = {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(
        np.float32) for k, s in tparams.flatten(params).items()}
    if "emb_atom" in p_np:
        p_np["emb_atom"] = rng.normal(size=p_np["emb_atom"].shape).astype(
            np.float32)
    p_np = tparams.unflatten(p_np)
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}

    @jax.jit
    def reference(p):
        return (jdn.apply(p, jb, jc),
                jax.value_and_grad(lambda q: jdn.loss_fn(q, jb, jc)[0])(p))

    out_j, (loss_j, grads_j) = reference(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    tc = tdn.DimeNetConfig(**dataclasses.asdict(jc))
    tb = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    leaves = {k: v.requires_grad_() for k, v in tparams.flatten(
        convert.params_from_numpy(p_np, "cpu")).items()}
    loss, metrics = tdn.loss_fn(tparams.unflatten(leaves), tb, tc)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        out = tdn.apply(tparams.unflatten(leaves), tb, tc)
    want = tparams.flatten(jax.tree_util.tree_map(np.asarray, grads_j))
    n_out = jc.n_targets if jc.readout == "node" else 1
    assert out.shape == (batch.get("n_graphs") or batch["pos"].shape[0],
                         n_out)
    assert _rel(out, out_j) <= FWD
    assert _rel(loss.detach(), loss_j) <= FWD
    assert list(metrics) == (["mse"] if jc.readout == "graph" else ["nll"])
    assert want.keys() == leaves.keys()
    for k, g in zip(leaves, grads):
        assert np.abs(want[k]).max() > 0, k
        assert _rel(g, want[k]) <= GRAD, k
