"""DimeNet (directional message passing, arXiv:2003.03123), PyTorch.

Counterpart of `repro/models/dimenet.py`: Bessel radial basis, spherical
basis j_l(z_ln r/c) * P_l(cos angle) over edge triplets (k->j, j->i),
low-rank (n_bilinear) bilinear interaction, `n_blocks` interaction
blocks, per-block output heads.

Message passing is gathers over the edge and triplet index lists and a
segment sum, as in the reference.  `jax.ops.segment_sum` becomes
`index_add` on a zero tensor (`sharding.segment_sum`): on the CPU it adds
in index order as XLA's scatter does; on CUDA it adds with atomics, so
the card agrees with the CPU within a float32 tolerance, not bit for
bit.  The gathers are `index_select` (`sharding.take`, shard-local on
DTensors), whose backward is that same
`index_add`: advanced indexing's backward (`index_put_` with
accumulate) sorts the indices and adds each index's duplicates in one
serial loop, and a sampled triplet list points most of its masked
triplets at one edge (a node without incoming edges samples the last
one), which made a minibatch_lg step on the H100 take 2.7 s.
The reference's `lax.scan(jax.checkpoint(block_fwd))` over the stacked
`blocks` leaves is a Python loop over the block index with each block
under `torch.utils.checkpoint` (`layers.checkpointed`): the backward
recomputes a block's node- and triplet-level intermediates instead of
keeping all six.

The bases keep the reference's float32 expressions in its order: its
clamps (`_envelope`'s max(d, 1e-6) before 1/d: the graphs carry
self-loops, so r = 1e-6 occurs and the envelope reaches about 1e6),
`lax.integer_pow`'s binary exponentiation for x ** n (`_ipow`), and the
small-argument series of j_l.  torch's and XLA's float32 sin / cos
differ by an ulp here and there; the tests bound what that moves.  The
edge messages pass through `sharding.constrain` where the reference's
do, and the edge and triplet masks scale their rows through
`sharding.scale_rows` (shard-local on DTensors).

`loss_fn_sharded` is the reference's local-triplets mode on a
`torch.distributed` group: each rank holds its own partition of the edge
and triplet lists (triplets index the rank's own edges), node inputs and
parameters are replicated, and the one cross-rank step is a SUM
all-reduce of `node_out` (`routing.sum_over_ranks`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import routing
from repro_torch.models.layers import checkpointed, dense
from repro_torch.models.params import P
from repro_torch.sharding import constrain, scale_rows, segment_sum, take


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    envelope_p: int = 6
    d_feat: Optional[int] = None   # feature graphs: input feature dim
    n_atom_types: int = 95         # molecules: atomic-number embedding
    n_targets: int = 1             # regression targets / classes
    readout: str = "graph"         # "graph" (molecules) | "node"
    # distributed mode: edges + triplets are PARTITIONED (triplet lists
    # local to the rank owning their target edge), so only the final
    # node_out reduction crosses ranks (`loss_fn_sharded`)
    local_triplets: bool = False


# --------------------------------------------------------------------------
# bases
# --------------------------------------------------------------------------

def _j_l_np(l: int, x: np.ndarray) -> np.ndarray:
    """Closed-form spherical Bessel j_l via upward recurrence (numpy)."""
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        j0 = np.where(x == 0, 1.0, np.sin(x) / x)
        if l == 0:
            return j0
        j1 = np.where(x == 0, 0.0, np.sin(x) / x**2 - np.cos(x) / x)
        jm, jc = j0, j1
        for n in range(1, l):
            jm, jc = jc, (2 * n + 1) / x * jc - jm
        return jc


@functools.lru_cache(maxsize=None)
def bessel_roots(n_spherical: int, n_radial: int) -> tuple:
    """First n_radial positive roots of j_l for l = 0..n_spherical-1
    (float64 bisection, the reference's root for root)."""
    out = []
    for l in range(n_spherical):
        xs = np.linspace(1e-3, (n_radial + l + 4) * np.pi, 20_000)
        ys = _j_l_np(l, xs)
        sign = np.sign(ys)
        idx = np.nonzero(sign[1:] * sign[:-1] < 0)[0][:n_radial]
        roots = []
        for i in idx:
            lo, hi = xs[i], xs[i + 1]
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if _j_l_np(l, np.array([lo]))[0] * _j_l_np(l, np.array([mid]))[0] <= 0:
                    hi = mid
                else:
                    lo = mid
            roots.append(0.5 * (lo + hi))
        out.append(tuple(roots))
    return tuple(out)


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for a Python int n >= 0 by binary exponentiation in float32
    multiplications, as `lax.integer_pow` lowers it (torch.pow may round
    differently)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def _rdiv(a: float, x: torch.Tensor) -> torch.Tensor:
    """a / x in one rounding (torch's `a / x` is a reciprocal, then a
    product).  The dividend is a 0-dim CPU tensor, which a CUDA op reads
    as a host scalar: `x.new_tensor(a)` would copy it to the card and
    synchronize, 92 times a DimeNet forward."""
    return torch.tensor(a, dtype=x.dtype) / x


def _f32(v: float) -> float:
    """A Python float holding v rounded to float32 (a scalar XLA folds in
    float32 before it meets a float32 array)."""
    return float(np.float32(v))


def _envelope(r, cutoff: float, p: int):
    """DimeNet smooth cutoff envelope u(d) (polynomial, C^2 at the cutoff)."""
    d = r / cutoff
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    d = torch.clamp(d, min=1e-6)
    env = _rdiv(1.0, d) + a * _ipow(d, p - 1) + b * _ipow(d, p) + c * _ipow(d, p + 1)
    return torch.where(d < 1.0, env, torch.zeros_like(env))


def radial_basis(r, cfg: DimeNetConfig):
    """(E,) distances -> (E, n_radial) Bessel RBF with envelope."""
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32,
                     device=r.device)
    env = _envelope(r, cfg.cutoff, cfg.envelope_p)
    return (env[:, None] * _f32(math.sqrt(_f32(2.0 / cfg.cutoff)))
            * torch.sin(n[None, :] * math.pi * r[:, None] / cfg.cutoff))


def _j_l(l: int, x):
    """Spherical Bessel j_l, float32-stable: the upward recurrence away
    from x < 1, the ascending series j_l(x) ~ x^l/(2l+1)!! (1 - ...)
    below it (the recurrence cancels catastrophically for x << l)."""
    x = torch.clamp(x, min=1e-6)
    safe = torch.clamp(x, min=1.0)  # recurrence evaluated away from the bad zone
    j0 = torch.sin(safe) / safe
    if l == 0:
        return torch.where(x < 1.0, torch.sin(x) / x, j0)
    jm, jc = j0, torch.sin(safe) / _ipow(safe, 2) - torch.cos(safe) / safe
    for n in range(1, l):
        jm, jc = jc, _rdiv(2 * n + 1, safe) * jc - jm
    dfact = 1.0
    for k in range(1, 2 * l + 2, 2):
        dfact *= k
    series = (_ipow(x, l) / dfact) * (
        1.0 - _ipow(x, 2) / (2.0 * (2 * l + 3))
        + _ipow(x, 4) / (8.0 * (2 * l + 3) * (2 * l + 5)))
    return torch.where(x < 1.0, series, jc)


def _legendre(l: int, c):
    if l == 0:
        return torch.ones_like(c)
    pm, pc = torch.ones_like(c), c
    for n in range(1, l):
        pm, pc = pc, ((2 * n + 1) * c * pc - n * pm) / (n + 1)
    return pc


def spherical_basis(r_kj, angle_cos, cfg: DimeNetConfig):
    """(T,) dist & cos(angle) -> (T, n_spherical * n_radial) SBF."""
    roots = bessel_roots(cfg.n_spherical, cfg.n_radial)
    env = _envelope(r_kj, cfg.cutoff, cfg.envelope_p)
    feats = []
    for l in range(cfg.n_spherical):
        ang = _legendre(l, angle_cos)
        for z in roots[l]:
            feats.append(env * _j_l(l, _f32(z) * r_kj / cfg.cutoff) * ang)
    # dim=1, not -1: torch 2.11's DTensor labels a stack on dim -1 of
    # (T,) shards on dim 0 as sharded on dim 1, though each rank holds rows
    return torch.stack(feats, dim=1)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def param_specs(cfg: DimeNetConfig) -> dict:
    d, nb = cfg.d_hidden, cfg.n_bilinear
    n_sbf = cfg.n_spherical * cfg.n_radial
    block = {
        "w_rbf": P((cfg.n_radial, d), (None, "mlp")),
        "w_sbf": P((n_sbf, nb), (None, None)),
        "w_down": P((d, nb), ("mlp", None)),
        "w_up": P((nb, d), (None, "mlp")),
        "w_msg1": P((d, d), ("mlp", "mlp")),
        "w_msg2": P((d, d), ("mlp", "mlp")),
        "out_rbf": P((cfg.n_radial, d), (None, "mlp")),
        "out_w1": P((d, d), ("mlp", "mlp")),
        "out_w2": P((d, cfg.n_targets), ("mlp", None), "zeros"),
    }
    specs = {
        "emb_rbf": P((cfg.n_radial, d), (None, "mlp")),
        "emb_edge": P((3 * d, d), ("mlp", "mlp")),
        "blocks": {k: P((cfg.n_blocks,) + p.shape, ("layers",) + p.axes,
                        p.init, p.dtype) for k, p in block.items()},
    }
    if cfg.d_feat is not None:
        specs["emb_node"] = P((cfg.d_feat, d), (None, "mlp"))
    else:
        specs["emb_atom"] = P((cfg.n_atom_types, d), (None, "mlp"), "embed")
    return specs


def model_flops(cfg: DimeNetConfig, n: int, e: int, t: int,
                d_feat: Optional[int]) -> float:
    """Forward + backward FLOPs of one step on n nodes, e edges and t
    triplets: the reference's `launch/cells._gnn_model_flops`."""
    d, nb = cfg.d_hidden, cfg.n_bilinear
    per_block = (e * (2 * 2 * d * d + 2 * d * cfg.n_radial)
                 + t * (2 * d * nb * 2 + 2 * nb * d)
                 + n * (2 * d * d))
    emb = e * 2 * 3 * d * d + n * 2 * (d_feat or 1) * d
    return 3.0 * (emb + cfg.n_blocks * per_block)  # fwd+bwd


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _block_fwd(m, node_out, rbf, sbf, kj, ji, dst, e_mask, n_nodes, *bp):
    """One interaction block + its output head (checkpointed per block)."""
    (w_rbf, w_sbf, w_down, w_up, w_msg1, w_msg2, out_rbf, out_w1,
     out_w2) = bp
    # directional interaction: gather messages of edges (k->j), gate by
    # rbf, low-rank bilinear with the angular basis, scatter to (j->i)
    gate = rbf @ w_rbf                                  # (E, d)
    x_kj = take(m * gate, kj)                           # (T, d)
    p_t = x_kj @ w_down                                 # (T, nb)
    q_t = sbf @ w_sbf                                   # (T, nb)
    t_msg = (p_t * q_t) @ w_up                          # (T, d)
    agg = segment_sum(t_msg, ji, m.shape[0])
    m_new = F.silu(m @ w_msg1 + agg @ w_msg2) + m
    if e_mask is not None:
        m_new = scale_rows(m_new, e_mask)
    m_new = constrain(m_new, "edges", None)
    # output block: edges -> nodes
    contrib = segment_sum(m_new * (rbf @ out_rbf), dst, n_nodes)
    node_out = node_out + dense(F.silu(contrib @ out_w1), out_w2).to(
        node_out.dtype)
    return m_new, node_out


_BLOCK_KEYS = ("w_rbf", "w_sbf", "w_down", "w_up", "w_msg1", "w_msg2",
               "out_rbf", "out_w1", "out_w2")


def apply(params, inputs, cfg: DimeNetConfig, psum_group=None):
    """inputs: pos (N,3), node features (x_feat (N,F) or atom_z (N,)),
    edge_src/edge_dst (E,), t_kj/t_ji (T,) triplet edge indices, t_mask (T,),
    optional edge_mask (E,), optional graph_id (N,) + n_graphs for graph
    readout.  Returns per-node (N, n_targets) or per-graph (G, n_targets)
    outputs.

    With `psum_group` (a `torch.distributed` group): edge/triplet arrays
    are this rank's partition (triplets indexing local edges); node-level
    inputs are replicated; the single cross-rank reduction is the
    node_out SUM (`routing.sum_over_ranks`).
    """
    pos = inputs["pos"]
    src, dst = inputs["edge_src"].long(), inputs["edge_dst"].long()
    n_nodes = pos.shape[0]

    if cfg.d_feat is not None:
        h = dense(inputs["x_feat"], params["emb_node"])
    else:
        h = take(params["emb_atom"], inputs["atom_z"].long())
    h = F.silu(h)

    # edge geometry
    vec = take(pos, dst) - take(pos, src)               # (E, 3)
    r = torch.sqrt(torch.clamp(_ipow(vec, 2).sum(-1), min=1e-12))  # (E,)
    rbf = radial_basis(r, cfg)                          # (E, n_radial)

    # triplet geometry: angle between edge kj and ji at shared node j
    kj, ji = inputs["t_kj"].long(), inputs["t_ji"].long()
    v1 = -take(vec, kj)                                 # j -> k
    v2 = take(vec, ji)                                  # j -> i
    cos_a = (v1 * v2).sum(-1) / torch.clamp(
        torch.sqrt(_ipow(v1, 2).sum(-1) * _ipow(v2, 2).sum(-1)), min=1e-9)
    sbf = spherical_basis(take(r, kj),
                          torch.clamp(cos_a, -1.0, 1.0), cfg)
    sbf = scale_rows(sbf, inputs["t_mask"])

    # edge embedding m_ji = MLP([h_j, h_i, rbf]); padded edges masked out
    e_mask = inputs.get("edge_mask")
    m = F.silu(dense(
        torch.cat([take(h, src), take(h, dst),
                   rbf @ params["emb_rbf"]], dim=-1),
        params["emb_edge"]))                            # (E, d)
    if e_mask is not None:
        m = scale_rows(m, e_mask)
    m = constrain(m, "edges", None)

    node_out = pos.new_zeros((n_nodes, cfg.n_targets))
    blocks = params["blocks"]
    for i in range(cfg.n_blocks):
        m, node_out = checkpointed(
            _block_fwd, m, node_out, rbf, sbf, kj, ji, dst, e_mask, n_nodes,
            *(blocks[k][i] for k in _BLOCK_KEYS))

    if psum_group is not None:
        # one reduction for all blocks (the sum of block contributions
        # commutes with the all-reduce); everything edge<->edge stayed local
        node_out = routing.sum_over_ranks(node_out, psum_group)
    if cfg.readout == "graph":
        return segment_sum(node_out, inputs["graph_id"].long(),
                            int(inputs["n_graphs"]))
    return node_out


def loss_fn(params, batch, cfg: DimeNetConfig, psum_group=None):
    out = apply(params, batch, cfg, psum_group=psum_group)
    if cfg.readout == "graph":
        err = out[:, 0] - batch["target"]
        loss = torch.mean(_ipow(err, 2))
        return loss, {"mse": loss}
    # node classification
    labels = batch["label"].long()
    logp = F.log_softmax(out, dim=-1)
    mask = batch.get("label_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"nll": loss}


def loss_fn_sharded(params, batch, cfg: DimeNetConfig, group=None):
    """The local-triplets distributed loss on a `torch.distributed` group
    (the world group by default), called by every rank.

    Each rank passes its own partition of the edge inputs (edge_src,
    edge_dst, edge_mask, t_kj, t_ji, t_mask; t_kj / t_ji index the rank's
    own edges) and the whole node-level inputs and parameters.  The loss
    comes from the all-reduced node_out, so every rank returns the same
    loss.  Gradients: each rank's is the part flowing through its own
    edges and triplets (`routing.sum_over_ranks`), and their SUM over the
    group is the gradient of the whole-graph `loss_fn`."""
    loss, _ = loss_fn(params, batch, cfg,
                      psum_group=dist.group.WORLD if group is None else group)
    return loss, {}
