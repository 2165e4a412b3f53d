"""Dry-run cell builders: (arch x shape x mesh) -> (step_fn, abstract args).

Counterpart of `repro/launch/cells.py`.  Everything here is built from
`models/params.abstract_tree`: inside the dry run's fake mode the
arguments are fake DTensors carrying `sharding_for`'s placements, and no
tensor is ever allocated.  Each builder returns a `Cell` with
    step_fn        the function the dry run calls once (train / serve step)
    abstract_args  tuple of abstract inputs
    rules          the logical->mesh rules the cell was built under
Training cells run the FULL train step (forward, backward, optimizer
update), so the peak memory counts real training residency (params,
grads, Adam moments / row-wise Adagrad, the checkpointed activations).

Where the reference passes `current_ctx()` to a routed function
(`loss_fn_sharded`, `dlrm_train_step_sparse`), the port passes the
mesh's world group or the mesh, and crosses from DTensors to local
shards at the function's boundary (`to_local`).  The routed DLRM path
expects each model rank's interleaved rows; its local shard of a
row-sharded table has the same shape, which is all a dry run reads.
Random keys are a constant raw key: no shape depends on their value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.data import graph as graph_lib
from repro_torch.models import dimenet as dn
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.models.params import P, abstract_tree, flatten, unflatten
from repro_torch.sharding import (GNN_RULES, LM_DECODE_RULES, LM_LONGCTX_RULES,
                                  LM_RULES, RECSYS_RULES, current_ctx)
from repro_torch.train.optimizer import (OptimizerConfig, default_label_fn,
                                         make_optimizer, opt_state_specs)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    step_fn: object
    abstract_args: tuple
    rules: dict
    kind: str
    notes: str = ""
    model_flops: float = 0.0   # analytic global FLOPs (6ND-style accounting)


def _mlp_flops(dims) -> float:
    return float(sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))


def lm_model_flops(cfg: tf.LMConfig, sp: dict) -> float:
    """Analytic global FLOPs: 6*N_active*D + attention scores (train),
    forward-only third for prefill, per-token cache attention for decode."""
    b, s = sp["batch"], sp["seq"]
    if sp["kind"] == "train":
        return tf.model_flops(cfg, n_tokens=b * s, seq_len=s)
    if sp["kind"] == "prefill":
        return tf.model_flops(cfg, n_tokens=b * s, seq_len=s) / 3.0
    # decode: one token against per-kind cache lengths
    n_active = tf.active_param_count(cfg)
    flops = 2.0 * n_active * b
    per_layer = cfg.n_layers / max(len(cfg.pattern), 1)
    for kind in cfg.pattern:
        L = cfg.cache_len(kind, s)
        flops += 4.0 * per_layer * L * cfg.d_head * cfg.n_heads * b
    return flops


def recsys_model_flops(arch, cfg, sp: dict) -> float:
    b = sp["batch"]
    mult = 3.0 if sp["kind"] == "train" else 1.0
    if arch.name == "dlrm-mlperf":
        n = cfg.n_sparse + 1
        per = (_mlp_flops(cfg.bot_mlp)
               + _mlp_flops((cfg.interact_dim,) + cfg.top_mlp)
               + 2.0 * n * n * cfg.embed_dim)
        if sp["kind"] == "retrieval":
            return per * sp["n_candidates"]
        return per * b * mult
    if arch.name in ("sasrec", "bert4rec"):
        d, S = cfg.embed_dim, cfg.seq_len
        per_tok = cfg.n_blocks * (8 * d * d + 4 * d * d + 4 * S * d)
        per = per_tok * S
        if sp["kind"] == "retrieval":
            return per + 2.0 * sp["n_candidates"] * d
        if sp["kind"] == "serve":
            return (per + 2.0 * cfg.n_items * d) * b
        return (per + 2.0 * (b + cfg.n_neg) * d) * b * mult
    # two-tower
    tower = 2 * _mlp_flops((cfg.embed_dim,) + cfg.tower)
    if sp["kind"] == "retrieval":
        return tower / 2 + sp["n_candidates"] * (tower / 2 + 2.0 * cfg.tower[-1])
    if sp["kind"] == "serve":
        return tower * b
    return (tower + 2.0 * b * cfg.tower[-1]) * b * mult


def _sds(shape, dtype, axes, rules, mesh):
    return abstract_tree(P(tuple(shape), axes, "zeros", dtype), rules, mesh)


def _scalar(dtype=torch.int32):
    return abstract_tree(P((), None, "zeros", dtype))


_KEY = np.array([0, 0], np.uint32)


def _train_wrapper(loss, opt_cfg: OptimizerConfig, label_fn=None):
    """A full train step around loss(params, batch, rng): the gradients of
    every parameter leaf, then the optimizer's in-place update."""
    kw = {} if label_fn is None else {"label_fn": label_fn}
    _, opt_update = make_optimizer(opt_cfg, **kw)

    def step(params, opt_state, batch, opt_step, seed):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten(params).items()}
        with torch.enable_grad():
            l, _ = loss(unflatten(leaves), batch, _KEY)
            grads = torch.autograd.grad(l, list(leaves.values()))
        new_p, new_o, stats = opt_update(
            unflatten(dict(zip(leaves, grads))), opt_state,
            unflatten(leaves), opt_step)
        return new_p, new_o, {"loss": l.detach(), **stats}

    return step


def _abstract_state(pspecs, rules, mesh, label_fn=None):
    kw = {} if label_fn is None else {"label_fn": label_fn}
    ospecs = opt_state_specs(pspecs, **kw)
    return (abstract_tree(pspecs, rules, mesh),
            abstract_tree(ospecs, rules, mesh))


def _local(tree):
    """The local shard of every DTensor leaf (the routed functions'
    boundary)."""
    return unflatten({k: getattr(v, "to_local", lambda v=v: v)()
                      for k, v in flatten(tree).items()})


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------

def _lm_cell(arch: registry.Arch, shape_name: str, mesh) -> Cell:
    sp = arch.shapes[shape_name]
    cfg: tf.LMConfig = arch.cfg
    kind = sp["kind"]
    b, s = sp["batch"], sp["seq"]

    if kind == "train":
        rules = LM_RULES
        pspecs = tf.param_specs(cfg)
        params_a, opt_a = _abstract_state(pspecs, rules, mesh)
        batch_a = {
            "tokens": _sds((b, s), torch.int32, ("batch", None), rules, mesh),
            "targets": _sds((b, s), torch.int32, ("batch", None), rules, mesh),
        }

        def loss(params, batch, rng):
            return tf.loss_fn(params, batch, cfg)

        step = _train_wrapper(loss, OptimizerConfig())
        args = (params_a, opt_a, batch_a, _scalar(), _scalar())
        return Cell(arch.name, shape_name, step, args, rules, kind,
                    model_flops=lm_model_flops(cfg, sp))

    if kind == "prefill":
        rules = LM_RULES
        # 32k full-score attention would need B*H*S^2 scores: force the
        # query-chunked path (a loop over 2k q-blocks)
        pcfg = dataclasses.replace(cfg, chunk_q=2048)
        params_a = abstract_tree(tf.param_specs(pcfg), rules, mesh)
        tokens_a = _sds((b, s), torch.int32, ("batch", "act_seq"), rules,
                        mesh)

        @torch.no_grad()
        def step(params, tokens):
            return tf.prefill(params, tokens, pcfg, max_len=s)

        return Cell(arch.name, shape_name, step, (params_a, tokens_a), rules,
                    kind, model_flops=lm_model_flops(cfg, sp))

    # decode
    rules = LM_LONGCTX_RULES if sp.get("long") else LM_DECODE_RULES
    params_a = abstract_tree(tf.param_specs(cfg), rules, mesh)
    cache_a = abstract_tree(tf.cache_specs(cfg, b, s), rules, mesh)
    tokens_a = _sds((b, 1), torch.int32, ("batch", None), rules, mesh)

    @torch.no_grad()
    def step(params, cache, tokens, pos):
        return tf.decode_step(params, cache, tokens, pos, cfg)

    return Cell(arch.name, shape_name, step,
                (params_a, cache_a, tokens_a, _scalar()), rules, kind,
                model_flops=lm_model_flops(cfg, sp))


# --------------------------------------------------------------------------
# RecSys cells
# --------------------------------------------------------------------------

def _recsys_cell(arch: registry.Arch, shape_name: str, mesh) -> Cell:
    sp = arch.shapes[shape_name]
    kind = sp["kind"]
    rules = RECSYS_RULES
    cfg = arch.cfg
    b = sp["batch"]
    mf = recsys_model_flops(arch, cfg, sp)

    if arch.name == "dlrm-mlperf":
        pspecs = rs.dlrm_specs(cfg)
        batch_a = {
            "dense": _sds((b, cfg.n_dense), torch.float32, ("batch", None),
                          rules, mesh),
            "sparse": _sds((b, cfg.n_sparse), torch.int32, ("batch", None),
                           rules, mesh),
            "label": _sds((b,), torch.float32, ("batch",), rules, mesh),
        }
        if kind == "train":
            if cfg.sparse_update:
                opt_cfg = OptimizerConfig()
                _, dense_update = make_optimizer(opt_cfg,
                                                 label_fn=lambda p: "dense")
                dense_specs = {k: pspecs[k] for k in ("bot", "top")}
                opt_specs = {
                    "dense": opt_state_specs(dense_specs,
                                             label_fn=lambda p: "dense"),
                    "tables": opt_state_specs(pspecs["tables"],
                                              label_fn=lambda p: "table"),
                }
                params_a = abstract_tree(pspecs, rules, mesh)
                opt_a = abstract_tree(opt_specs, rules, mesh)

                def step(params, opt_state, batch, opt_step, seed):
                    ctx = current_ctx()
                    routed = cfg.lookup == "a2a" and ctx is not None
                    if routed:  # the routed code runs on local shards
                        params, opt_state, batch = (
                            _local(params), _local(opt_state), _local(batch))
                    return rs.dlrm_train_step_sparse(
                        params, opt_state, batch, opt_step, seed, cfg,
                        opt_cfg, dense_update,
                        mesh=ctx[1] if routed else None)
            else:
                params_a, opt_a = _abstract_state(pspecs, rules, mesh,
                                                  default_label_fn)
                step = _train_wrapper(
                    lambda p, bt, r: rs.dlrm_loss(p, bt, cfg),
                    OptimizerConfig(), default_label_fn)
            return Cell(arch.name, shape_name, step,
                        (params_a, opt_a, batch_a, _scalar(), _scalar()),
                        rules, kind, model_flops=mf)
        params_a = abstract_tree(pspecs, rules, mesh)
        if kind == "serve":
            step = torch.no_grad()(lambda p, bt: rs.dlrm_apply(p, bt, cfg))
            return Cell(arch.name, shape_name, step, (params_a, batch_a),
                        rules, kind, model_flops=mf)
        # retrieval: one context row vs n_candidates
        nc = sp["n_candidates"]
        cand_a = _sds((nc,), torch.int32, ("candidates",), rules, mesh)
        one = {
            "dense": _sds((1, cfg.n_dense), torch.float32, None, rules, mesh),
            "sparse": _sds((1, cfg.n_sparse), torch.int32, None, rules, mesh),
        }
        step = torch.no_grad()(
            lambda p, bt, c: rs.dlrm_score_candidates(p, bt, c, cfg))
        return Cell(arch.name, shape_name, step, (params_a, one, cand_a),
                    rules, kind, model_flops=mf)

    if arch.name in ("sasrec", "bert4rec"):
        pspecs = rs.sasrec_specs(cfg)
        hist_a = _sds((b, cfg.seq_len), torch.int32, ("batch", None), rules,
                      mesh)
        if kind == "train":
            params_a, opt_a = _abstract_state(pspecs, rules, mesh,
                                              default_label_fn)
            batch_a = {"history": hist_a,
                       "target": _sds((b,), torch.int32, ("batch",), rules,
                                      mesh)}
            loss = (rs.bert4rec_loss if arch.name == "bert4rec"
                    else rs.sasrec_loss)
            step = _train_wrapper(lambda p, bt, r: loss(p, bt, cfg, r),
                                  OptimizerConfig(), default_label_fn)
            return Cell(arch.name, shape_name, step,
                        (params_a, opt_a, batch_a, _scalar(), _scalar()),
                        rules, kind, model_flops=mf)
        params_a = abstract_tree(pspecs, rules, mesh)
        if kind == "serve":
            @torch.no_grad()
            def step(p, hist):
                h = rs.sasrec_encode(p, hist, cfg)[:, -1]
                return rs.topk_over_catalog(p, h, cfg)
            return Cell(arch.name, shape_name, step, (params_a, hist_a),
                        rules, kind, model_flops=mf)
        nc = sp["n_candidates"]
        hist1 = _sds((1, cfg.seq_len), torch.int32, None, rules, mesh)
        cand_a = _sds((nc,), torch.int32, ("candidates",), rules, mesh)

        @torch.no_grad()
        def step(p, hist, cand):
            h = rs.sasrec_encode(p, hist, cfg)[:, -1]
            return rs.score_candidates(p, h, cand)
        return Cell(arch.name, shape_name, step, (params_a, hist1, cand_a),
                    rules, kind, model_flops=mf)

    # two-tower
    pspecs = rs.twotower_specs(cfg)
    batch_a = {
        "user_feats": _sds((b, cfg.n_user_feats), torch.int32,
                           ("batch", None), rules, mesh),
        "item_feats": _sds((b, cfg.n_item_feats), torch.int32,
                           ("batch", None), rules, mesh),
        "item_logq": _sds((b,), torch.float32, ("batch",), rules, mesh),
    }
    if kind == "train":
        params_a, opt_a = _abstract_state(pspecs, rules, mesh,
                                          default_label_fn)
        step = _train_wrapper(lambda p, bt, r: rs.twotower_loss(p, bt, cfg),
                              OptimizerConfig(), default_label_fn)
        return Cell(arch.name, shape_name, step,
                    (params_a, opt_a, batch_a, _scalar(), _scalar()),
                    rules, kind, model_flops=mf)
    params_a = abstract_tree(pspecs, rules, mesh)
    if kind == "serve":
        step = torch.no_grad()(lambda p, bt: rs.twotower_embed(p, bt, cfg))
        return Cell(arch.name, shape_name, step, (params_a, batch_a),
                    rules, kind, model_flops=mf)
    nc = sp["n_candidates"]
    one = {"user_feats": _sds((1, cfg.n_user_feats), torch.int32, None,
                              rules, mesh)}
    cand_a = _sds((nc, cfg.n_item_feats), torch.int32, ("candidates", None),
                  rules, mesh)
    step = torch.no_grad()(
        lambda p, bt, c: rs.twotower_score_candidates(p, bt, c, cfg))
    return Cell(arch.name, shape_name, step, (params_a, one, cand_a),
                rules, kind, model_flops=mf)


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------

def _pad512(n: int) -> int:
    """Shard-divisible length for edge/triplet lists (512 = lcm of meshes)."""
    return n + (-n) % 512


def gnn_sizes(sp: dict) -> tuple:
    """(n nodes, padded e edges, t triplets) of a GNN shape."""
    if "batch" in sp:  # molecule
        n, e = sp["batch"] * sp["n_nodes"], sp["batch"] * sp["n_edges"]
    elif sp.get("sampled"):
        n, e = graph_lib.subgraph_sizes(sp["batch_nodes"], list(sp["fanout"]))
    else:
        n, e = sp["n_nodes"], sp["n_edges"]
    e = _pad512(e)
    return n, e, e * sp["max_angular"]


_EDGE_KEYS = ("edge_src", "edge_dst", "edge_mask", "t_kj", "t_ji", "t_mask")


def _gnn_cell(arch: registry.Arch, shape_name: str, mesh) -> Cell:
    sp = arch.shapes[shape_name]
    rules = GNN_RULES
    base: dn.DimeNetConfig = arch.cfg
    n, e, t = gnn_sizes(sp)

    if shape_name == "molecule":
        cfg = dataclasses.replace(base, readout="graph", n_targets=1)
        extra = {
            "atom_z": _sds((n,), torch.int32, ("nodes",), rules, mesh),
            "graph_id": _sds((n,), torch.int32, ("nodes",), rules, mesh),
            "target": _sds((sp["batch"],), torch.float32, ("batch",), rules,
                           mesh),
        }
        n_graphs = sp["batch"]
    else:
        cfg = dataclasses.replace(base, readout="node", d_feat=sp["d_feat"],
                                  n_targets=sp["n_classes"])
        extra = {
            "x_feat": _sds((n, sp["d_feat"]), torch.float32, ("nodes", None),
                           rules, mesh),
            "label": _sds((n,), torch.int32, ("nodes",), rules, mesh),
            "label_mask": _sds((n,), torch.float32, ("nodes",), rules, mesh),
        }
        n_graphs = None

    batch_a = {
        "pos": _sds((n, 3), torch.float32, ("nodes", None), rules, mesh),
        "edge_src": _sds((e,), torch.int32, ("edges",), rules, mesh),
        "edge_dst": _sds((e,), torch.int32, ("edges",), rules, mesh),
        "edge_mask": _sds((e,), torch.float32, ("edges",), rules, mesh),
        "t_kj": _sds((t,), torch.int32, ("triplets",), rules, mesh),
        "t_ji": _sds((t,), torch.int32, ("triplets",), rules, mesh),
        "t_mask": _sds((t,), torch.float32, ("triplets",), rules, mesh),
        **extra,
    }
    params_a, opt_a = _abstract_state(dn.param_specs(cfg), rules, mesh)

    def loss(params, batch, rng):
        if n_graphs is not None:
            batch = dict(batch, n_graphs=n_graphs)
        ctx = current_ctx()
        if cfg.local_triplets and ctx is not None:
            # the routed loss runs on this rank's edge and triplet shards
            # and on whole node- and graph-level inputs
            batch = {k: v.to_local() if k in _EDGE_KEYS else (
                v.full_tensor() if hasattr(v, "full_tensor") else v)
                for k, v in batch.items()}
            return dn.loss_fn_sharded(_local(params), batch, cfg,
                                      group=dist.group.WORLD)
        return dn.loss_fn(params, batch, cfg)

    step = _train_wrapper(loss, OptimizerConfig())
    return Cell(arch.name, shape_name, step,
                (params_a, opt_a, batch_a, _scalar(), _scalar()),
                rules, sp["kind"],
                notes=f"n={n} e={e} triplets={t} "
                      f"(angular cap {sp['max_angular']})",
                model_flops=dn.model_flops(cfg, n, e, t, sp.get("d_feat")))


def build_cell(arch_name: str, shape_name: str, mesh) -> Cell:
    arch = registry.get(arch_name)
    if shape_name in arch.skip_shapes:
        raise ValueError(f"{arch_name}/{shape_name} is a documented skip: "
                         f"{arch.notes}")
    if arch.family == "lm":
        return _lm_cell(arch, shape_name, mesh)
    if arch.family == "recsys":
        return _recsys_cell(arch, shape_name, mesh)
    if arch.family == "gnn":
        return _gnn_cell(arch, shape_name, mesh)
    raise ValueError(arch.family)
