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


def cross_entropy(logits, targets, z_loss: float = 0.0):
    """Token-mean CE in fp32 with optional z-loss regularizer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss
