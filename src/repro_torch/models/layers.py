"""Shared neural-net layers (pure functions over param dicts), PyTorch.

Counterpart of `repro/models/layers.py`.  Weights keep the reference's
`(in, out)` layout (`dense` is `x @ w`), so parameters carry across
without transposes.  Under `sharding.use_rules` the same functions run
on DTensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.models.params import P
from repro_torch.sharding import (chunk_range, from_local, is_dtensor,
                                  matmul, replicated)


def rms_norm(x, scale, eps: float = 1e-6, unit_offset: bool = False):
    """RMSNorm; unit_offset=True uses the (1 + scale) Gemma convention."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = (1.0 + scale) if unit_offset else scale
    return (y * w).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def dense(x, w, b=None):
    y = matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def mlp_specs(d_model: int, d_ff: int, gated: bool = True) -> dict:
    """SwiGLU/GeGLU ('gated') or plain 2-layer MLP param specs."""
    specs = {
        "up": P((d_model, d_ff), ("embed", "mlp")),
        "down": P((d_ff, d_model), ("mlp", "embed")),
    }
    if gated:
        specs["gate"] = P((d_model, d_ff), ("embed", "mlp"))
    return specs


_ACTS = {"silu": F.silu, "gelu": lambda v: F.gelu(v, approximate="tanh"),
         "relu": F.relu}


def mlp_apply(params, x, activation: str = "silu"):
    act = _ACTS[activation]
    up = dense(x, params["up"])
    if "gate" in params:
        up = act(dense(x, params["gate"])) * up
    else:
        up = act(up)
    return dense(up, params["down"])


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding over the last dim. x: (..., S, H, D), positions
    (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _row_shard(table, ids):
    """The pieces of a lookup into a DTensor table: (local table, local
    ids shifted into this rank's rows, in-shard mask, output placements,
    mesh, the ids as placed).  Mesh dims sharding the rows give a partial
    sum (every other rank of the group contributes zeros); dims sharding
    the columns shard the output's last dim; elsewhere the output takes
    the ids' placement.  The ids are replicated on every mesh dim the
    table shards."""
    mesh, pl = table.device_mesh, table.placements
    ids = replicated(ids, mesh)
    ids = ids.redistribute(mesh, [Replicate() if p.is_shard() else q
                                  for p, q in zip(pl, ids.placements)])
    lo, rows = chunk_range(table.shape[0], mesh,
                           [d for d, p in enumerate(pl) if p.is_shard(0)])
    out_pl = [Partial("sum") if p.is_shard(0) else
              Shard(ids.ndim) if p.is_shard() else q
              for p, q in zip(pl, ids.placements)]
    local = ids.to_local().long()
    mine = (local >= lo) & (local < lo + rows)
    return (table.to_local(), torch.where(mine, local - lo, 0), mine, out_pl,
            mesh, ids)


def embed_lookup(table, ids):
    """`table[ids]`.  A DTensor table looks its own rows up on each rank
    (`_row_shard`): a row-sharded table gives a partial sum that the
    next `constrain` reduces, and no rank gathers the table."""
    if not is_dtensor(table):
        return F.embedding(ids.long(), table)
    t_loc, i_loc, mine, out_pl, mesh, ids = _row_shard(table, ids)
    out = F.embedding(i_loc, t_loc) * mine[..., None].to(t_loc.dtype)
    return from_local(out, mesh, out_pl, tuple(ids.shape) + (table.shape[1],))


def embedding_bag(table, ids, mode: str = "mean", weights=None):
    """Gather + reduce over the bag dim: table (V, D); ids (..., bag) ->
    (..., D).  One `F.embedding_bag` call, so the (..., bag, D) gather is
    never materialized (1M candidates x 8 ids x 256 floats would be
    8.19 GB)."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    if is_dtensor(table):
        return _sharded_bag(table, ids, mode, weights)
    lead, bag = ids.shape[:-1], ids.shape[-1]
    flat = ids.reshape(-1, bag).long()
    if weights is None:
        out = F.embedding_bag(flat, table, mode=mode)
    else:
        w = weights.reshape(-1, bag).to(table.dtype)
        if mode == "max":  # weighted max has no fused form
            out = (F.embedding(flat, table) * w[..., None]).amax(dim=-2)
        else:
            out = F.embedding_bag(flat, table, mode="sum",
                                  per_sample_weights=w)
        if mode == "mean":
            out = out / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-6)
    return out.reshape(*lead, table.shape[-1])


def _sharded_bag(table, ids, mode: str, weights):
    """`embedding_bag` of a DTensor table: each rank reduces the rows it
    holds.  "sum" / "mean" are one `F.embedding_bag` with the in-shard
    mask (times the weights; for "mean" over the bag length or the
    weights' sum) as per-sample weights, a partial sum over the mesh dims
    sharding the rows.  "max" takes -inf for rows held elsewhere, a
    partial max.  The weights follow the ids' placement."""
    t_loc, i_loc, mine, out_pl, mesh, ids = _row_shard(table, ids)
    bag = ids.shape[-1]
    # the bag dim is reduced: a column shard lands on the output's last dim
    out_pl = [Shard(ids.ndim - 1) if p.is_shard(ids.ndim) else p
              for p in out_pl]
    w = mine.to(t_loc.dtype)
    if weights is not None:
        weights = replicated(weights, mesh).redistribute(mesh,
                                                         ids.placements)
        w = w * weights.to_local().to(t_loc.dtype)
    flat = i_loc.reshape(-1, bag)
    if mode == "max":
        vecs = F.embedding(flat, t_loc)
        if weights is not None:
            vecs = vecs * weights.to_local().reshape(-1, bag, 1).to(
                t_loc.dtype)
        vecs = vecs.masked_fill(~mine.reshape(-1, bag, 1), float("-inf"))
        out = vecs.amax(dim=-2)
        out_pl = [Partial("max") if p.is_partial() else p for p in out_pl]
    else:
        if mode == "mean":
            w = w / (bag if weights is None else torch.clamp(
                weights.to_local().sum(dim=-1, keepdim=True), min=1e-6))
        out = F.embedding_bag(flat, t_loc, mode="sum",
                              per_sample_weights=w.reshape(-1, bag))
    out = out.reshape(*mine.shape[:-1], t_loc.shape[-1])
    return from_local(out, mesh, out_pl,
                      tuple(ids.shape[:-1]) + (table.shape[1],))


class _LseAndPick(torch.autograd.Function):
    """(logsumexp, logits at the targets) over the last dim, with a
    backward that builds the logits' gradient in ONE tensor:
    exp(logits - lse) * g_lse, then g_pick added at the targets in place.
    Autograd's own backward of the pair holds three logits-sized
    temporaries (the difference, its exp and the scattered pick) besides
    the saved logits: 44 GiB more for an LM batch of 32 x 1,024 tokens
    over a 120,000-token vocabulary.  The values are the same products
    and sums."""

    @staticmethod
    def forward(ctx, logits, targets):
        lse = torch.logsumexp(logits, dim=-1)
        pick = torch.gather(logits, -1, targets[..., None])[..., 0]
        ctx.save_for_backward(logits, lse, targets)
        return lse, pick

    @staticmethod
    def backward(ctx, g_lse, g_pick):
        logits, lse, targets = ctx.saved_tensors
        if g_lse is None:
            grad = torch.zeros_like(logits)
        else:
            grad = torch.sub(logits, lse[..., None]).exp_()
            grad.mul_(g_lse[..., None])
        if g_pick is not None:
            grad.scatter_add_(-1, targets[..., None], g_pick[..., None])
        return grad, None


class _ShardLseAndPick(torch.autograd.Function):
    """`_LseAndPick` on one rank's vocabulary shard [lo, lo + V_loc) of
    logits sharded over `groups`: the row max and the exp sum are
    all-reduced over each group in turn, and the target's logit comes
    from the one rank whose shard holds it (a sum of zeros elsewhere).
    The backward is local: the upstream gradients are the same on every
    rank of the groups."""

    @staticmethod
    def forward(ctx, logits, targets, lo, groups):
        import torch.distributed._functional_collectives as funcol

        m = logits.amax(dim=-1)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        s = torch.sub(logits, m[..., None]).exp_().sum(dim=-1)
        mine = (targets >= lo) & (targets < lo + logits.shape[-1])
        idx = torch.where(mine, targets - lo, 0)
        pick = torch.gather(logits, -1, idx[..., None])[..., 0] * mine
        for g in groups:
            s = funcol.all_reduce(s, "sum", g)
            pick = funcol.all_reduce(pick, "sum", g)
        lse = m + torch.log(s)
        ctx.save_for_backward(logits, lse, idx, mine)
        return lse, pick

    @staticmethod
    def backward(ctx, g_lse, g_pick):
        logits, lse, idx, mine = ctx.saved_tensors
        if g_lse is None:
            grad = torch.zeros_like(logits)
        else:
            grad = torch.sub(logits, lse[..., None]).exp_()
            grad.mul_(g_lse[..., None])
        if g_pick is not None:
            grad.scatter_add_(-1, idx[..., None], (g_pick * mine)[..., None])
        return grad, None, None, None


def _sharded_lse_and_pick(logits, targets):
    """(logsumexp, logits at the targets) of DTensor logits, vocabulary-
    parallel: no rank gathers the vocabulary dimension.  Pending partial
    sums are reduced first; the targets take the logits' placements on
    the leading dimensions."""
    mesh, last = logits.device_mesh, logits.ndim - 1
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    lead = [Replicate() if p.is_shard(last) else p for p in pl]
    targets = replicated(targets, mesh).redistribute(mesh, lead)
    dims = [d for d, p in enumerate(pl) if p.is_shard(last)]
    lo, _ = chunk_range(logits.shape[last], mesh, dims)
    lse, pick = _ShardLseAndPick.apply(logits.to_local(), targets.to_local(),
                                       lo, [mesh.get_group(d) for d in dims])
    return tuple(from_local(t, mesh, lead, targets.shape)
                 for t in (lse, pick))


def cross_entropy(logits, targets, z_loss: float = 0.0):
    """Token-mean CE in fp32 with optional z-loss regularizer.  DTensor
    logits take the vocabulary-parallel form (`_sharded_lse_and_pick`)."""
    if is_dtensor(logits):
        lse, ll = _sharded_lse_and_pick(logits.float(), targets.long())
    else:
        lse, ll = _LseAndPick.apply(logits.float(), targets.long())
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


def top_k(x, k: int):
    """`jax.lax.top_k` over the last dim of float32 `x`: (values, int64
    indices), largest first, equal values by the lower index first.

    `torch.topk` promises no order among equal values, so the selection
    runs on unique int64 keys: the value's bits mapped to an order-keeping
    int32 in the high word, the complement of its index in the low one."""
    n = x.shape[-1]
    if n >= 2**31:
        raise ValueError("top_k indexes at most 2^31 - 1 elements")
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    order = torch.where(bits < 0, bits ^ 0x7FFF_FFFF, bits)
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    keys = (order << 32) | (n - 1 - idx)
    j = torch.topk(keys, k, dim=-1).values & 0xFFFF_FFFF
    j = n - 1 - j
    return torch.gather(x, -1, j), j


def checkpointed(fn, *args, context_fn=None):
    """fn(*args) under `torch.utils.checkpoint` (non-reentrant) when autograd
    records: the backward recomputes fn's activations instead of keeping
    them, as `jax.checkpoint` does.  Outside autograd it is a plain call.
    `context_fn`: a selective policy's contexts
    (`create_selective_checkpoint_contexts`)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
