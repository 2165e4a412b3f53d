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
and Llama-4 Scout (16 routed top-1 + 1 shared).  `moe_apply_a2a` is the
manual expert parallelism of the reference: every rank of a
`torch.distributed` group keeps its tokens and owns E / W experts, and
one capacity-bounded all-to-all pair (`routing.route` / `send_back`)
carries the (token, k) rows to their experts and back.  The expert
slots pass through `sharding.constrain` where the reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import routing
from repro_torch.models.layers import mlp_apply, mlp_specs, top_k
from repro_torch.models.params import P
from repro_torch.sharding import constrain, einsum, matmul, reshape


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


def _router(params, x, c: MoEConfig):
    """(gates (T, k), idx (T, k), aux): the router, top-k
    with `jax.lax.top_k`'s tie order, and the load-balance aux loss
    (Switch): E * sum_e fraction_e * router_prob_e."""
    logits = matmul(x, params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                         # (T, E)
    gates, idx = top_k(probs, c.top_k)                            # (T, k)
    if c.norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    one_hot = F.one_hot(idx[:, 0], c.n_experts).float()
    aux = (c.n_experts * torch.mean(one_hot.mean(0) * probs.mean(0))
           * c.n_experts)
    return gates, idx, aux


def _experts(params, h):
    """(E, C, d) slots -> (E, C, d): the gated expert FFNs."""
    up = einsum("ecd,edf->ecf", h, params["up"].to(h.dtype))
    gate = einsum("ecd,edf->ecf", h, params["gate"].to(h.dtype))
    return einsum("ecf,efd->ecd", F.silu(gate) * up,
                        params["down"].to(h.dtype))


def moe_apply(params, x, c: MoEConfig):
    """x: (T, D) flattened tokens -> (y: (T, D), aux_loss: float32 scalar)."""
    t, d = x.shape
    cap = capacity(c, t)
    n_slots = c.n_experts * cap
    gates, idx, aux = _router(params, x, c)

    flat_e = idx.reshape(-1)                                      # (T*k,)
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    counts = torch.zeros(c.n_experts, dtype=torch.int64,  # static bincount
                         device=x.device).index_add(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * c.top_k, device=x.device) - offsets[sorted_e]
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, n_slots))

    tok = torch.div(sort_idx, c.top_k, rounding_mode="floor")
    # row n_slots is the spare that takes every dropped token, sliced off
    slots = x.new_zeros((n_slots + 1, d)).index_put(
        (dest,), x[tok] * keep[:, None].to(x.dtype))[:n_slots]
    h = constrain(reshape(slots, c.n_experts, cap, d), "experts", None, None)
    out = constrain(_experts(params, h), "experts", None, None)

    padded = torch.cat([reshape(out, -1, d), out.new_zeros((1, d))], dim=0)
    y_sorted = padded[torch.clamp(dest, max=n_slots)]
    y_flat = x.new_zeros((t * c.top_k, d)).index_put((sort_idx,), y_sorted)
    y = (y_flat.reshape(t, c.top_k, d)
         * gates[..., None].to(x.dtype)).sum(dim=1)
    if c.n_shared:
        y = y + mlp_apply(params["shared"], x)
    return y, aux.float()


# --------------------------------------------------------------------------
# manual expert parallelism: all-to-all token routing over a group
# --------------------------------------------------------------------------

def moe_apply_a2a(params_loc, x, c: MoEConfig, *, group=None,
                  mean_group=None):
    """Expert-parallel MoE over the ranks of `group` (every rank calls it).

    Tokens stay local: each rank routes its (token, k) rows to the rank
    owning the chosen expert with one capacity-bounded all-to-all
    (`routing.route`), computes its local experts' GEMMs, and returns the
    results with the inverse all-to-all (`send_back`).

    params_loc: the router and shared leaves whole, the expert leaves
    gate / up / down this rank's (E / W, ...) slice (rank r owns experts
    r * E / W ...); x: (T_loc, d) local tokens.  Returns (y (T_loc, d),
    aux averaged over `mean_group`; `group` when None).
    """
    n_shards = dist.get_world_size(group)
    e_loc = c.n_experts // n_shards
    t, d = x.shape
    gates, idx, aux = _router(params_loc, x, c)
    mean_group = group if mean_group is None else mean_group
    aux = (routing.sum_over_ranks(aux, mean_group)
           / dist.get_world_size(mean_group))

    flat_e = idx.reshape(-1)                               # (T*k,)
    x_rep = torch.repeat_interleave(x, c.top_k, dim=0)     # (T*k, d)
    dest = torch.div(flat_e, e_loc, rounding_mode="floor")
    cap_wire = max(8, int(t * c.top_k / n_shards * c.wire_capacity_factor))
    recv, rt = routing.route({"x": x_rep, "e": flat_e}, dest, cap_wire,
                             group)

    rows = recv["x"]                                       # (R, d), zeros if invalid
    local_e = recv["e"] % e_loc                            # local expert id
    cap_loc = max(8, int(rows.shape[0] / e_loc * c.capacity_factor))
    grouped, slot2, _ = routing.local_group_by({"x": rows}, local_e, e_loc,
                                               cap_loc)
    out = _experts(params_loc, grouped["x"])               # (E_loc, C, d)
    rows_out = routing.ungroup(out, slot2, e_loc, cap_loc)  # (R, d)
    y_flat = routing.send_back(rows_out, rt, group)        # (T*k, d)
    y = (y_flat.reshape(t, c.top_k, d)
         * gates[..., None].to(x.dtype)).sum(dim=1)
    if c.n_shared:
        y = y + mlp_apply(params_loc["shared"], x)
    return y, aux.float()
