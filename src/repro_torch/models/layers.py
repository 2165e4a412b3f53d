"""Shared neural-net layers (pure functions over param dicts), PyTorch.

Counterpart of `repro/models/layers.py`.  Weights keep the reference's
`(in, out)` layout (`dense` is `x @ w`), so parameters carry across
without transposes.  The reference's `sharding.constrain` calls do
nothing outside its `use_rules` context; the port leaves them out until
a sharding slice brings `torch.distributed` placement.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from repro_torch.models.params import P


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
    y = x @ w.to(x.dtype)
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


def embed_lookup(table, ids):
    return F.embedding(ids.long(), table)


def embedding_bag(table, ids, mode: str = "mean", weights=None):
    """Gather + reduce over the bag dim: table (V, D); ids (..., bag) ->
    (..., D).  One `F.embedding_bag` call, so the (..., bag, D) gather is
    never materialized (1M candidates x 8 ids x 256 floats would be
    8.19 GB)."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
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


def cross_entropy(logits, targets, z_loss: float = 0.0):
    """Token-mean CE in fp32 with optional z-loss regularizer."""
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
