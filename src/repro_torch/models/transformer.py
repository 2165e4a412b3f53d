"""Decoder-only LM family, PyTorch: the five LM architectures of the
registry.

Counterpart of `repro/models/transformer.py`.  One config describes them
all:
  * layer `pattern` -- repeating kinds, e.g. ("local", "global") for
    Gemma-2, ("chunked",)*3 + ("global",) for Llama-4 iRoPE, ("global",)
    for the rest;
  * attention = GQA (optional qkv bias / softcap / per-arch query scale)
    or MLA (DeepSeek latent attention, absorbed decode path);
  * FFN = gated MLP or MoE (sort dispatch), with an optional dense prefix
    (DeepSeek-V2's first layer).

Parameters keep the reference's tree: `(in, out)` weights, and `blocks`
stacked on a leading layer-group axis (one group = one pattern period),
as are the KV caches, so `convert.params_from_numpy` carries a JAX tree
across leaf for leaf.  Where the reference scans over the group axis
(`jax.lax.scan`), the port loops over it in Python on views of the
stacked leaves; decode and prefill stack each group's new cache back.

Remat wraps each group in `torch.utils.checkpoint` (non-reentrant) while
autograd records, by `cfg.remat`:
  * "full" -- save nothing, recompute the group (`jax.checkpoint`);
  * "none" -- save everything (no checkpoint);
  * "dots" -- save the outputs of the matrix products with no batch dims
    (`aten.mm` / `aten.addmm`: the dense projections) and recompute the
    rest, through `torch.utils.checkpoint.create_selective_checkpoint_contexts`,
    the counterpart of `dots_with_no_batch_dims_saveable`; where that
    API is missing, "dots" runs as "full".
Values do not depend on the policy.

`moe.impl == "a2a"` goes through `_moe_shardmap`: inside
`sharding.use_rules(rules, mesh)` with a "model" mesh axis, tokens stay
on their rank and `moe.moe_apply_a2a` routes them to the experts of the
model group; with no such mesh it runs `moe_apply`, as the reference
does.  The residual stream passes through `sharding.constrain` where
the reference's does (`_embed`, `_group_fwd`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (checkpointed, cross_entropy, dense,
                                       embed_lookup, mlp_apply, mlp_specs,
                                       rms_norm, softcap)
from repro_torch.models.params import P, flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # attention
    attn_kind: str = "gqa"                    # "gqa" | "mla"
    mla: Optional[attn.MLAConfig] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    pattern: tuple = ("global",)
    window: Optional[int] = None              # for "local" layers
    attn_chunk: Optional[int] = None          # for "chunked" layers
    rope_on_global: bool = True               # Llama-4 iRoPE: False
    # ffn
    activation: str = "silu"
    moe: Optional[moe_lib.MoEConfig] = None
    n_dense_prefix: int = 0                   # leading dense-FFN layers
    d_ff_prefix: Optional[int] = None
    # output / norms
    post_norms: bool = False                  # Gemma-2 extra norms
    norm_unit_offset: bool = False            # Gemma (1 + scale) RMSNorm
    final_softcap: Optional[float] = None
    embed_scale: bool = False                 # Gemma sqrt(d) embed scaling
    tie_embeddings: bool = False
    # numerics / scheduling
    dtype: object = torch.bfloat16
    chunk_q: Optional[int] = None             # query-chunked attention
    kv_chunk: Optional[int] = None            # flash-style online softmax
    remat: str = "full"
    z_loss: float = 1e-4

    @property
    def n_groups(self) -> int:
        n = self.n_layers - self.n_dense_prefix
        if n % len(self.pattern):
            raise ValueError(f"{self.name}: {n} layers do not divide into "
                             f"periods of {self.pattern}")
        return n // len(self.pattern)

    def gqa(self) -> attn.GQAConfig:
        return attn.GQAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            rope_theta=self.rope_theta, qkv_bias=self.qkv_bias,
            attn_softcap=self.attn_softcap, query_scale=self.query_scale)

    def cache_len(self, kind: str, max_len: int) -> int:
        if kind == "local":
            return min(self.window, max_len)
        if kind == "chunked":
            return min(self.attn_chunk, max_len)
        return max_len


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

def _norm_spec(cfg: LMConfig) -> P:
    init = "zeros" if cfg.norm_unit_offset else "ones"
    return P((cfg.d_model,), (None,), init)


def _layer_specs(cfg: LMConfig, use_moe: bool, d_ff: int) -> dict:
    if cfg.attn_kind == "mla":
        a = attn.mla_specs(cfg.mla)
    else:
        a = attn.gqa_specs(cfg.gqa())
    specs = {"attn": a, "ln_attn": _norm_spec(cfg), "ln_mlp": _norm_spec(cfg)}
    if cfg.post_norms:
        specs["ln_attn_post"] = _norm_spec(cfg)
        specs["ln_mlp_post"] = _norm_spec(cfg)
    if use_moe:
        specs["moe"] = moe_lib.moe_specs(cfg.moe)
    else:
        specs["mlp"] = mlp_specs(cfg.d_model, d_ff, gated=True)
    return specs


def _stack_specs(specs, n: int):
    return tree_map(
        lambda p: P((n,) + p.shape,
                    ("layers",) + (p.axes or (None,) * len(p.shape)),
                    p.init, p.dtype), specs)


def param_specs(cfg: LMConfig) -> dict:
    use_moe = cfg.moe is not None
    group = {f"l{j}": _layer_specs(cfg, use_moe, cfg.d_ff)
             for j in range(len(cfg.pattern))}
    specs = {
        "embed": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                   "normal:0.02"),
        "blocks": _stack_specs(group, cfg.n_groups),
        "ln_final": _norm_spec(cfg),
    }
    for i in range(cfg.n_dense_prefix):
        specs[f"prefix{i}"] = _layer_specs(cfg, False,
                                           cfg.d_ff_prefix or cfg.d_ff)
    if not cfg.tie_embeddings:
        specs["head"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                          "normal:0.02")
    return specs


def _at(stacked: dict, g: int) -> dict:
    """Group g of a tree stacked on the group axis (views)."""
    return tree_map(lambda a: a[g], stacked)


def _stack(groups: list) -> dict:
    """The per-group trees stacked back on a leading group axis."""
    flats = [flatten(t) for t in groups]
    return unflatten({k: torch.stack([f[k] for f in flats])
                      for k in flats[0]})


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _attend_layer(p, x, positions, cfg: LMConfig, kind: str, cache,
                  mode: str):
    use_rope = cfg.rope_on_global if kind == "global" else True
    if cfg.attn_kind == "mla":
        if mode == "decode":
            return attn.mla_decode(p, x, positions, cfg.mla, cache)
        return attn.mla_prefill(p, x, positions, cfg.mla,
                                chunk_q=cfg.chunk_q, kv_chunk=cfg.kv_chunk,
                                want_cache=(mode == "prefill"))
    return attn.gqa_apply(p, x, positions, cfg.gqa(), kind=kind,
                          window=cfg.window, attn_chunk=cfg.attn_chunk,
                          use_rope=use_rope, cache=cache,
                          chunk_q=cfg.chunk_q if mode != "decode" else None,
                          kv_chunk=cfg.kv_chunk if mode != "decode" else None,
                          want_cache=(mode == "prefill"))


def _layer(p, x, positions, cfg: LMConfig, kind: str, cache=None,
           mode: str = "train"):
    h = rms_norm(x, p["ln_attn"], unit_offset=cfg.norm_unit_offset)
    a, new_cache = _attend_layer(p["attn"], h, positions, cfg, kind, cache,
                                 mode)
    if cfg.post_norms:
        a = rms_norm(a, p["ln_attn_post"], unit_offset=cfg.norm_unit_offset)
    x = x + a
    h = rms_norm(x, p["ln_mlp"], unit_offset=cfg.norm_unit_offset)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        if cfg.moe.impl == "a2a":
            f, aux = _moe_shardmap(p["moe"], h, cfg)
        else:
            t, d = h.shape[0] * h.shape[1], h.shape[2]
            f, aux = moe_lib.moe_apply(p["moe"], sharding.reshape(h, t, d),
                                       cfg.moe)
            f = sharding.reshape(f, *x.shape)
    else:
        f = mlp_apply(p["mlp"], h, cfg.activation)
    if cfg.post_norms:
        f = rms_norm(f, p["ln_mlp_post"], unit_offset=cfg.norm_unit_offset)
    return x + f, new_cache, aux


def _moe_shardmap(params, h, cfg: LMConfig):
    """Manual expert parallelism around the MoE FFN.

    With a mesh holding a "model" axis active (`sharding.use_rules`),
    this rank's tokens stay here and the expert leaves gate / up / down
    are cut to this rank's E / model slice (the reference's
    P("model", ...) in_specs over the whole leaves every rank holds);
    routing is one pair of capacity-bounded all-to-alls over the model
    axis's group (`moe_apply_a2a`), and the aux loss is averaged over the
    whole mesh (the world group).  With no mesh it runs `moe_apply`."""
    ctx = sharding.current_ctx()
    if ctx is None or "model" not in sharding.mesh_shape(ctx[1]):
        t, d = h.shape[0] * h.shape[1], h.shape[2]
        f, aux = moe_lib.moe_apply(params, sharding.reshape(h, t, d), cfg.moe)
        return sharding.reshape(f, *h.shape), aux
    mesh = ctx[1]
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    e_loc = cfg.moe.n_experts // n_model
    lo = mesh.get_local_rank("model") * e_loc
    p_loc = {k: v[lo:lo + e_loc] if k in ("gate", "up", "down") else v
             for k, v in params.items()}
    y, aux = moe_lib.moe_apply_a2a(p_loc, h.reshape(-1, h.shape[-1]),
                                   cfg.moe, group=mesh.get_group("model"),
                                   mean_group=dist.group.WORLD)
    return y.reshape(h.shape), aux


def _group_fwd(block, x, positions, cfg: LMConfig, caches=None,
               mode: str = "train"):
    new_caches = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, kind in enumerate(cfg.pattern):
        cache_j = caches[f"l{j}"] if caches is not None else None
        x, nc, aux = _layer(block[f"l{j}"], x, positions, cfg, kind,
                            cache_j, mode)
        if nc is not None:
            new_caches[f"l{j}"] = nc
        aux_total = aux_total + aux
    x = sharding.constrain(x, "batch", "act_seq", "act_embed")
    return x, new_caches, aux_total


def _embed(params, tokens, cfg: LMConfig):
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return sharding.constrain(x, "batch", "act_seq", "act_embed")


def _head(params, x, cfg: LMConfig):
    x = rms_norm(x, params["ln_final"], unit_offset=cfg.norm_unit_offset)
    if cfg.tie_embeddings:
        logits = sharding.matmul(x, params["embed"].to(x.dtype).T)
    else:
        logits = dense(x, params["head"])
    return softcap(logits.float(), cfg.final_softcap)


def _dots_context():
    """The selective-checkpoint context of the "dots" policy, or None where
    `create_selective_checkpoint_contexts` is missing ("full" then)."""
    try:
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts)
    except ImportError:
        return None
    saveable = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saveable
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)


def apply(params, tokens, cfg: LMConfig):
    """Training/eval forward: tokens (B, S) -> (logits (B, S, V) float32,
    aux)."""
    b, s = tokens.shape
    positions = _positions(s, tokens.device)
    x = _embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_dense_prefix):
        x, _, _ = _layer(params[f"prefix{i}"], x, positions, cfg, "global")

    def body(block, x):
        x, _, a = _group_fwd(block, x, positions, cfg)
        return x, a

    for g in range(cfg.n_groups):
        block = _at(params["blocks"], g)
        if cfg.remat == "none":
            x, a = body(block, x)
        else:
            ctx = _dots_context() if cfg.remat == "dots" else None
            x, a = checkpointed(functools.partial(body, block), x,
                                context_fn=ctx)
        aux = aux + a
    return _head(params, x, cfg), aux


def loss_fn(params, batch, cfg: LMConfig):
    logits, aux = apply(params, batch["tokens"], cfg)
    ce = cross_entropy(logits, batch["targets"], z_loss=cfg.z_loss)
    total = ce + (cfg.moe.aux_weight * aux / cfg.n_layers if cfg.moe
                  else 0.0)
    return total, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------

def cache_specs(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """P-spec tree of the KV cache."""
    def one(kind: str) -> dict:
        L = cfg.cache_len(kind, max_len)
        if cfg.attn_kind == "mla":
            return {
                "ckv": P((batch, L, cfg.mla.kv_lora),
                         ("batch", "kv_seq", None), "zeros", cfg.dtype),
                "kr": P((batch, L, cfg.mla.qk_rope),
                        ("batch", "kv_seq", None), "zeros", cfg.dtype),
                "pos": P((L,), ("kv_seq",), "neg_ones", torch.int32),
            }
        return {
            "k": P((batch, L, cfg.n_kv_heads, cfg.d_head),
                   ("batch", "kv_seq", "cache_heads", None), "zeros",
                   cfg.dtype),
            "v": P((batch, L, cfg.n_kv_heads, cfg.d_head),
                   ("batch", "kv_seq", "cache_heads", None), "zeros",
                   cfg.dtype),
            "pos": P((L,), ("kv_seq",), "neg_ones", torch.int32),
        }

    group = {f"l{j}": one(kind) for j, kind in enumerate(cfg.pattern)}
    specs = {"blocks": _stack_specs(group, cfg.n_groups)}
    for i in range(cfg.n_dense_prefix):
        specs[f"prefix{i}"] = one("global")
    return specs


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    """Zero K/V and -1 positions; CUDA unless `device` is "cpu"."""
    dev = resolve_device(device)

    def mk(p: P):
        fill = -1 if p.init == "neg_ones" else 0
        return torch.full(p.shape, fill, dtype=p.dtype, device=dev)

    return tree_map(mk, cache_specs(cfg, batch, max_len))


def decode_step(params, cache, tokens, pos, cfg: LMConfig):
    """One token step.  tokens (B, 1); pos a 0-dim int tensor (or an int)
    -> (logits (B, V), new cache).  The input cache is left as it was."""
    pos = torch.as_tensor(pos, device=tokens.device)
    positions = pos.reshape(1).to(torch.int32)
    x = _embed(params, tokens, cfg)
    new_cache = {}
    for i in range(cfg.n_dense_prefix):
        x, nc, _ = _layer(params[f"prefix{i}"], x, positions, cfg, "global",
                          cache[f"prefix{i}"], mode="decode")
        new_cache[f"prefix{i}"] = nc
    groups = []
    for g in range(cfg.n_groups):
        x, ncs, _ = _group_fwd(_at(params["blocks"], g), x, positions, cfg,
                               _at(cache["blocks"], g), mode="decode")
        groups.append(ncs)
    new_cache["blocks"] = _stack(groups)
    logits = _head(params, x, cfg)
    return logits[:, 0], new_cache


def prefill(params, tokens, cfg: LMConfig, max_len: int):
    """Prefill a prompt; returns (last-token logits (B, V), cache)."""
    b, s = tokens.shape
    positions = _positions(s, tokens.device)
    x = _embed(params, tokens, cfg)
    out_cache = {}
    for i in range(cfg.n_dense_prefix):
        x, nc, _ = _layer(params[f"prefix{i}"], x, positions, cfg, "global",
                          mode="prefill")
        out_cache[f"prefix{i}"] = _pack_cache(nc, "global", cfg, s, max_len)
    groups = []
    for g in range(cfg.n_groups):
        x, ncs, _ = _group_fwd(_at(params["blocks"], g), x, positions, cfg,
                               mode="prefill")
        groups.append({f"l{j}": _pack_cache(ncs[f"l{j}"], kind, cfg, s,
                                            max_len)
                       for j, kind in enumerate(cfg.pattern)})
    out_cache["blocks"] = _stack(groups)
    logits = _head(params, x[:, -1:], cfg)
    return logits[:, 0], out_cache


def _pack_cache(raw, kind: str, cfg: LMConfig, s: int, max_len: int):
    """Convert prefill K/V (length s) into the fixed decode cache layout."""
    L = cfg.cache_len(kind, max_len)
    lo = max(0, s - L)
    dev = raw["pos"].device
    positions = torch.arange(lo, s, dtype=torch.int32, device=dev)
    slots = (positions % L if kind in ("local", "chunked")
             else positions).long()

    def place(x):
        # slot = position % L over the last L positions: a rotation of the
        # block, so slices and a concatenation (no index write, which
        # DTensor has no strategy for on a sharded sequence)
        blk, n = x[:, lo:s], s - lo
        if n < L:  # then lo = 0 and slot p holds position p
            return torch.cat([blk, blk.new_zeros(
                (blk.shape[0], L - n) + blk.shape[2:])], dim=1)
        r = lo % L if kind in ("local", "chunked") else 0
        return torch.cat([blk[:, L - r:], blk[:, :L - r]], dim=1) if r \
            else blk

    pos = torch.full((L,), -1, dtype=torch.int32, device=dev)
    pos[slots] = positions
    if cfg.attn_kind == "mla":
        return {"ckv": place(raw["ckv"]), "kr": place(raw["kr"]), "pos": pos}
    return {"k": place(raw["k"]), "v": place(raw["v"]), "pos": pos}


# --------------------------------------------------------------------------
# accounting
# --------------------------------------------------------------------------

def active_param_count(cfg: LMConfig) -> int:
    """Parameters touched per token (MoE counts top_k + shared experts)."""
    d, h = cfg.d_model, cfg.n_heads * cfg.d_head
    kvh = cfg.n_kv_heads * cfg.d_head
    if cfg.attn_kind == "mla":
        m = cfg.mla
        a = (d * m.n_heads * (m.qk_nope + m.qk_rope) + d * m.kv_lora
             + d * m.qk_rope + m.kv_lora * m.n_heads * (m.qk_nope + m.v_dim)
             + m.n_heads * m.v_dim * d)
    else:
        a = d * h * 2 + d * kvh * 2
    dense_ffn = 3 * d * cfg.d_ff
    if cfg.moe is not None:
        c = cfg.moe
        ffn = (3 * d * c.d_ff_expert * c.top_k + 3 * d * c.shared_ff
               + d * c.n_experts)
    else:
        ffn = dense_ffn
    n_moe = cfg.n_layers - cfg.n_dense_prefix
    prefix_ffn = 3 * d * (cfg.d_ff_prefix or cfg.d_ff)
    return (cfg.n_layers * a + n_moe * ffn
            + cfg.n_dense_prefix * prefix_ffn)


def model_flops(cfg: LMConfig, n_tokens: int, seq_len: int) -> float:
    """6*N_active*D + attention score FLOPs (12*L*S*d_head*H per token)."""
    base = 6.0 * active_param_count(cfg) * n_tokens
    attn_f = (12.0 * cfg.n_layers * seq_len * cfg.d_head * cfg.n_heads
              * n_tokens)
    return base + attn_f
