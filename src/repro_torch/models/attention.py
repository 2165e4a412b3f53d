"""Attention family, PyTorch: GQA (+local/chunked variants, softcap) and MLA.

Counterpart of `repro/models/attention.py`.  One `attend` primitive
covers every LM arch of the registry:

  * masks are pure position predicates (causal / sliding-window / chunked /
    bidirectional), so local-global interleaving is a per-layer flag;
    cache slots not yet written carry position -1 and are masked first;
  * `chunk_q` switches between full-score attention (S^2 scores
    materialized) and a Python loop over query chunks (peak
    B*H*chunk*S scores instead of B*H*S*S), each chunk under
    `torch.utils.checkpoint` when autograd records, as the reference
    checkpoints its `lax.map` body;
  * `kv_chunk` is the flash-style online softmax over KV tiles, each
    tile's step checkpointed as the reference's `jax.checkpoint(step)`;
  * grouped KV heads are folded into the einsum, so K/V are never
    materialized per q-head.

The scores are computed with `torch.einsum` and `torch.softmax`, in the
reference's order: float32 scores times the scale, the softcap, the
mask as a -2e38 fill, the softmax in float32, then a cast to v's dtype.
No library attention kernel (`scaled_dot_product_attention` and the
like) is used: it applies neither the softcap before the mask nor the
finite fill, so it would compute another function.

MLA (DeepSeek-V2) has the prefill path (per-head K/V from the rank-512
latent) and the absorbed decode path (scores against the cached latent;
W_uk/W_uv folded into the query/output projections).

Caches update as `jax.lax.dynamic_update_slice` does: the start is
clamped so the update fits (a chunked layer past its cache length
writes the last slot), by `index_copy` on device indices (no host
synchronize; `sharding.update_slice`, shard by shard on a mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.layers import (checkpointed, dense, rms_norm, rope,
                                       softcap)
from repro_torch.models.params import P
from repro_torch.sharding import einsum, reshape, update_slice

NEG_INF = -2.0e38


def _mask(q_pos, k_pos, kind: str, window: int | None, chunk: int | None):
    """(Q, K) boolean mask from position vectors ((1, K) for "bidir")."""
    q = q_pos[:, None]
    k = k_pos[None, :]
    valid = k_pos[None, :] >= 0  # cache slots not yet written have pos -1
    if kind == "bidir":
        return valid
    m = (k <= q) & valid
    if kind == "local":
        m &= (q - k) < window
    elif kind == "chunked":
        m &= torch.div(q, chunk, rounding_mode="floor") == torch.div(
            k, chunk, rounding_mode="floor")
    return m


def _scores_softmax(q, k, v, q_pos, k_pos, *, kind, window, attn_chunk,
                    scale, cap):
    """Full-materialization attention for one q block.

    q: (B, Q, N, G, D) -- N kv heads x G groups; k/v: (B, S, N, D).
    """
    s = einsum("bqngd,bsnd->bngqs", q, k).float() * scale
    s = softcap(s, cap)
    m = _mask(q_pos, k_pos, kind, window, attn_chunk)
    s = torch.where(m[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return einsum("bngqs,bsnd->bqngd", p, v)


def _online_attend(q5, k, v, q_pos, k_pos, *, kind, window, attn_chunk,
                   scale, cap, kv_chunk: int):
    """Flash-style attention: a loop over KV tiles with a running
    (row-max, denominator, accumulator) carry; each tile's scores are
    touched once and never materialized for the whole row."""
    b, sq, n, g, d = q5.shape
    sk = k.shape[1]
    if sk % kv_chunk:
        raise ValueError(f"kv length {sk} is not a multiple of {kv_chunk}")
    dv = v.shape[-1]

    def step(m, l, acc, k_i, v_i, p_i):
        s = einsum("bqngd,bsnd->bngqs", q5, k_i).float() * scale
        s = softcap(s, cap)
        mask = _mask(q_pos, p_i, kind, window, attn_chunk)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + einsum(
            "bngqs,bsnd->bngqd", p.to(v_i.dtype), v_i).float()
        return m_new, l, acc

    dev = q5.device
    m = torch.full((b, n, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n, g, sq, dv), dtype=torch.float32, device=dev)
    # checkpoint: backward recomputes each tile's probabilities instead of
    # keeping every tile's (B,N,G,Sq,c) scores
    for i in range(0, sk, kv_chunk):
        m, l, acc = checkpointed(step, m, l, acc, k[:, i:i + kv_chunk],
                                 v[:, i:i + kv_chunk], k_pos[i:i + kv_chunk])
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)  # (B, Sq, N, G, Dv)


def attend(q, k, v, q_pos, k_pos, *, kind: str = "global",
           window: int | None = None, attn_chunk: int | None = None,
           scale: float, cap: float | None = None,
           chunk_q: int | None = None, remat_chunks: bool = True,
           kv_chunk: int | None = None):
    """q: (B, Sq, H, D); k/v: (B, Sk, N, D) with H = N * G. -> (B, Sq, H, Dv)."""
    b, sq, h, d = q.shape
    n = k.shape[2]
    g = h // n
    dv = v.shape[-1]  # may differ from d (MLA: d_qk=192, d_v=128)
    q5 = reshape(q, b, sq, n, g, d)
    kw = dict(kind=kind, window=window, attn_chunk=attn_chunk, scale=scale,
              cap=cap)
    if kv_chunk is not None and k.shape[1] % kv_chunk == 0 and sq > 1:
        out = _online_attend(q5, k, v, q_pos, k_pos, kv_chunk=kv_chunk, **kw)
        return reshape(out, b, sq, h, dv)
    if chunk_q is None or sq <= chunk_q:
        out = _scores_softmax(q5, k, v, q_pos, k_pos, **kw)
        return reshape(out, b, sq, h, dv)
    if sq % chunk_q:
        raise ValueError(f"query length {sq} is not a multiple of {chunk_q}")

    def one(qi, pi):
        return _scores_softmax(qi, k, v, pi, k_pos, **kw)

    outs = []
    for i in range(0, sq, chunk_q):
        qi, pi = q5[:, i:i + chunk_q], q_pos[i:i + chunk_q]
        # without the checkpoint, every chunk's float32 scores would stay
        # alive as backward residuals; recompute instead
        outs.append(checkpointed(one, qi, pi) if remat_chunks
                    else one(qi, pi))
    return reshape(torch.cat(outs, dim=1), b, sq, h, dv)


# --------------------------------------------------------------------------
# GQA block
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GQAConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    query_scale: Optional[float] = None  # default 1/sqrt(d_head)


def gqa_specs(c: GQAConfig) -> dict:
    specs = {
        "wq": P((c.d_model, c.n_heads * c.d_head), ("embed", "heads")),
        "wk": P((c.d_model, c.n_kv_heads * c.d_head), ("embed", "kv_heads")),
        "wv": P((c.d_model, c.n_kv_heads * c.d_head), ("embed", "kv_heads")),
        "wo": P((c.n_heads * c.d_head, c.d_model), ("heads", "embed")),
    }
    if c.qkv_bias:
        specs["bq"] = P((c.n_heads * c.d_head,), ("heads",), "zeros")
        specs["bk"] = P((c.n_kv_heads * c.d_head,), ("kv_heads",), "zeros")
        specs["bv"] = P((c.n_kv_heads * c.d_head,), ("kv_heads",), "zeros")
    return specs


def gqa_apply(params, x, positions, c: GQAConfig, *, kind="global",
              window=None, attn_chunk=None, use_rope=True,
              cache: dict | None = None, chunk_q: int | None = None,
              want_cache: bool = False, kv_chunk: int | None = None):
    """x: (B, S, D); positions (S,) int32 on x's device.  With `cache`, S
    is the new-token count (decode=1); returns (out, new_cache)."""
    b, s, _ = x.shape
    q = reshape(dense(x, params["wq"], params.get("bq")), b, s, c.n_heads,
                c.d_head)
    k = reshape(dense(x, params["wk"], params.get("bk")), b, s, c.n_kv_heads,
                c.d_head)
    v = reshape(dense(x, params["wv"], params.get("bv")), b, s, c.n_kv_heads,
                c.d_head)
    if use_rope:
        q = rope(q, positions, c.rope_theta)
        k = rope(k, positions, c.rope_theta)
    scale = c.query_scale if c.query_scale is not None else c.d_head ** -0.5

    new_cache = None
    if cache is not None:
        slots = (positions % cache["k"].shape[1]) if kind == "local" \
            else positions
        ck = update_slice(cache["k"], k, slots[0], 1)
        cv = update_slice(cache["v"], v, slots[0], 1)
        cpos = update_slice(cache["pos"], positions.to(torch.int32),
                             slots[0], 0)
        new_cache = {"k": ck, "v": cv, "pos": cpos}
        k, v, k_pos = ck, cv, cpos
    else:
        k_pos = positions
        if want_cache:  # prefill: raw K/V, packed into slots by the caller
            new_cache = {"k": k, "v": v, "pos": positions.to(torch.int32)}

    out = attend(q, k, v, positions, k_pos, kind=kind, window=window,
                 attn_chunk=attn_chunk, scale=scale, cap=c.attn_softcap,
                 chunk_q=chunk_q, kv_chunk=kv_chunk)
    return dense(reshape(out, b, s, -1), params["wo"]), new_cache


# --------------------------------------------------------------------------
# MLA block (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    rope_theta: float = 10_000.0


def mla_specs(c: MLAConfig) -> dict:
    return {
        "wq": P((c.d_model, c.n_heads * (c.qk_nope + c.qk_rope)),
                ("embed", "heads")),
        "wdkv": P((c.d_model, c.kv_lora), ("embed", None)),
        "kv_norm": P((c.kv_lora,), (None,), "ones"),
        "wkr": P((c.d_model, c.qk_rope), ("embed", None)),
        "wuk": P((c.kv_lora, c.n_heads * c.qk_nope), (None, "heads")),
        "wuv": P((c.kv_lora, c.n_heads * c.v_dim), (None, "heads")),
        "wo": P((c.n_heads * c.v_dim, c.d_model), ("heads", "embed")),
    }


def _mla_qkr(params, x, positions, c: MLAConfig):
    b, s, _ = x.shape
    q = reshape(dense(x, params["wq"]), b, s, c.n_heads, c.qk_nope + c.qk_rope)
    q_nope, q_rope = q[..., :c.qk_nope], q[..., c.qk_nope:]
    q_rope = rope(q_rope, positions, c.rope_theta)
    ckv = rms_norm(dense(x, params["wdkv"]), params["kv_norm"])  # (B,S,L)
    k_rope = rope(dense(x, params["wkr"])[:, :, None, :], positions,
                  c.rope_theta)[:, :, 0, :]                       # (B,S,R)
    return q_nope, q_rope, ckv, k_rope


def mla_prefill(params, x, positions, c: MLAConfig, *, chunk_q=None,
                want_cache: bool = False, kv_chunk=None):
    """Training / prefill path: per-head K,V materialized from the latent."""
    b, s, _ = x.shape
    q_nope, q_rope, ckv, k_rope = _mla_qkr(params, x, positions, c)
    k_nope = reshape(dense(ckv, params["wuk"]), b, s, c.n_heads, c.qk_nope)
    v = reshape(dense(ckv, params["wuv"]), b, s, c.n_heads, c.v_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, c.n_heads, c.qk_rope)], dim=-1)
    scale = (c.qk_nope + c.qk_rope) ** -0.5
    out = attend(q, k, v, positions, positions, kind="global", scale=scale,
                 chunk_q=chunk_q, kv_chunk=kv_chunk)
    y = dense(reshape(out, b, s, -1), params["wo"])
    cache = ({"ckv": ckv, "kr": k_rope, "pos": positions.to(torch.int32)}
             if want_cache else None)
    return y, cache


def mla_decode(params, x, positions, c: MLAConfig, cache: dict):
    """Absorbed decode: attention runs directly against the cached latent."""
    b, s, _ = x.shape  # s == new tokens (1)
    q_nope, q_rope, ckv_new, kr_new = _mla_qkr(params, x, positions, c)
    ckv = update_slice(cache["ckv"], ckv_new, positions[0], 1)
    kr = update_slice(cache["kr"], kr_new, positions[0], 1)
    cpos = update_slice(cache["pos"], positions.to(torch.int32),
                         positions[0], 0)
    wuk = reshape(params["wuk"], c.kv_lora, c.n_heads, c.qk_nope)
    q_lat = einsum("bqhd,lhd->bqhl", q_nope, wuk.to(q_nope.dtype))
    s_lat = einsum("bqhl,bsl->bhqs", q_lat, ckv.to(q_lat.dtype))
    s_rot = einsum("bqhr,bsr->bhqs", q_rope, kr.to(q_rope.dtype))
    scale = (c.qk_nope + c.qk_rope) ** -0.5
    scores = (s_lat + s_rot).float() * scale
    m = _mask(positions, cpos, "global", None, None)
    scores = torch.where(m[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = einsum("bhqs,bsl->bqhl", p, ckv.to(p.dtype))
    wuv = reshape(params["wuv"], c.kv_lora, c.n_heads, c.v_dim)
    out = einsum("bqhl,lhv->bqhv", ctx, wuv.to(ctx.dtype))
    y = dense(reshape(out, b, s, -1), params["wo"])
    return y, {"ckv": ckv, "kr": kr, "pos": cpos}
