"""Mixture-of-Experts FFN, PyTorch: top-k routing, capacity-based sort
dispatch.

Counterpart of `repro/models/moe.py`.  Dispatch is the sorted/grouped
form: tokens are ranked within their expert by a stable sort, dropped
past the capacity, scattered into (E, C, D) slots, batch-matmul'd per
expert, and combined with their router gates.  Dispatch memory stays at
O(T * k * D) instead of O(T * E * C).

The reference's semantics, kept exactly:
  * `jax.lax.top_k` breaks ties by the lower expert index:
    `layers.top_k` does too (`torch.topk` promises no order);
  * `jnp.argsort` is stable: `torch.sort(stable=True)`;
  * `.at[dest].set(..., mode="drop")` drops the overflow slot
    `n_experts * cap`: the port writes into one spare row and slices it
    off.

Covers DeepSeek-V2 (64 routed top-6 + 2 shared, normalized top-k gates)
and Llama-4 Scout (16 routed top-1 + 1 shared).  `moe_apply_a2a` (manual
expert parallelism over a mesh axis) comes with the sharding slice: with
no mesh, the reference's `_moe_shardmap` runs `moe_apply`, and so does
the port's transformer for `impl="a2a"`.  The reference's
`sharding.constrain` calls wait for that slice too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp_apply, mlp_specs, top_k
from repro_torch.models.params import P


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: Optional[int] = None   # default n_shared * d_ff_expert
    capacity_factor: float = 1.25
    norm_topk: bool = False             # DeepSeek renormalizes top-k gates
    aux_weight: float = 1e-2
    impl: str = "gspmd"                 # "gspmd" (sort+scatter)
                                        # | "a2a" (manual expert parallelism)
    wire_capacity_factor: float = 1.5   # a2a: per-destination-shard slack

    @property
    def shared_ff(self) -> int:
        if self.n_shared == 0:
            return 0
        return self.d_ff_shared or self.n_shared * self.d_ff_expert


def moe_specs(c: MoEConfig) -> dict:
    specs = {
        "router": P((c.d_model, c.n_experts), ("embed", None), "normal:0.02"),
        "gate": P((c.n_experts, c.d_model, c.d_ff_expert),
                  ("experts", "embed", "expert_mlp")),
        "up": P((c.n_experts, c.d_model, c.d_ff_expert),
                ("experts", "embed", "expert_mlp")),
        "down": P((c.n_experts, c.d_ff_expert, c.d_model),
                  ("experts", "expert_mlp", "embed")),
    }
    if c.n_shared:
        specs["shared"] = mlp_specs(c.d_model, c.shared_ff, gated=True)
    return specs


def capacity(c: MoEConfig, n_tokens: int) -> int:
    cap = int(math.ceil(n_tokens * c.top_k / c.n_experts * c.capacity_factor))
    return max(8, cap + (-cap) % 8)  # sublane-aligned


def moe_apply(params, x, c: MoEConfig):
    """x: (T, D) flattened tokens -> (y: (T, D), aux_loss: float32 scalar)."""
    t, d = x.shape
    cap = capacity(c, t)
    n_slots = c.n_experts * cap
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                         # (T, E)
    gates, idx = top_k(probs, c.top_k)                            # (T, k)
    if c.norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * sum_e fraction_e * router_prob_e
    one_hot = F.one_hot(idx[:, 0], c.n_experts).float()
    aux = (c.n_experts * torch.mean(one_hot.mean(0) * probs.mean(0))
           * c.n_experts)

    flat_e = idx.reshape(-1)                                      # (T*k,)
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=c.n_experts)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * c.top_k, device=x.device) - offsets[sorted_e]
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, n_slots))

    tok = torch.div(sort_idx, c.top_k, rounding_mode="floor")
    # row n_slots is the spare that takes every dropped token, sliced off
    slots = x.new_zeros((n_slots + 1, d)).index_put(
        (dest,), x[tok] * keep[:, None].to(x.dtype))[:n_slots]
    h = slots.reshape(c.n_experts, cap, d)
    up = torch.einsum("ecd,edf->ecf", h, params["up"].to(h.dtype))
    gate = torch.einsum("ecd,edf->ecf", h, params["gate"].to(h.dtype))
    out = torch.einsum("ecf,efd->ecd", F.silu(gate) * up,
                       params["down"].to(h.dtype))

    padded = torch.cat([out.reshape(-1, d), out.new_zeros((1, d))], dim=0)
    y_sorted = padded[torch.clamp(dest, max=n_slots)]
    y_flat = x.new_zeros((t * c.top_k, d)).index_put((sort_idx,), y_sorted)
    y = (y_flat.reshape(t, c.top_k, d)
         * gates[..., None].to(x.dtype)).sum(dim=1)
    if c.n_shared:
        y = y + mlp_apply(params["shared"], x)
    return y, aux.float()
