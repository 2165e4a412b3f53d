"""Generic capacity-bounded all-to-all routing on `torch.distributed`.

Counterpart of `repro/routing.py`.  One abstraction, three users:
  * the paper's key-routed distributed sketch (`core/sharded.py`: its
    uint32 key dispatch keeps its own layout, over `all_to_all` and
    `all_gather` here),
  * all-to-all expert parallelism for MoE FFNs (`models/moe.moe_apply_a2a`),
  * row-sharded embedding-table lookup (`models/recsys.dlrm_lookup_a2a`).

`route` packs payloads (a tensor, or a dict / list / tuple of them) into
fixed (n_shards, capacity, ...) buffers keyed by a destination rank per
row, exchanges them with `all_to_all_single`, and returns enough routing
state to send per-row results back to their origin (`send_back`).
Every shape is static, and the exchange is differentiable with respect
to the payloads: its backward is the inverse exchange (`_Exchange`), so
the same machinery runs in training steps.

`sum_over_ranks` is the one reduction the routed models need (DimeNet's
node outputs, the MoE aux loss).  Every function that exchanges or
reduces is called by every rank of `group` (the world group by
default), as the reference's run inside `shard_map` over an axis;
`group` takes the place of the reference's `axis_name`.  The packing
sorts stably (`jnp.argsort` is stable), so the slot layout, the
rows dropped past the capacity included, is the reference's slot for
slot.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.counters import signed_view


@dataclasses.dataclass
class Routing:
    """Routing state: how local rows were packed into the send buffer."""
    slot_of_row: torch.Tensor  # (N,) int64 flat slot in the send buffer, or n*cap
    kept: torch.Tensor         # (N,) bool: False if dropped by capacity
    recv_valid: torch.Tensor   # (n_shards * capacity,) bool at the receiver
    n_shards: int
    capacity: int


def _map(fn, tree):
    """fn over every tensor of a tensor / dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _pack(payload, dest: torch.Tensor, n_shards: int, capacity: int):
    n = dest.shape[0]
    dest = dest.long()
    sorted_dest, order = torch.sort(dest, stable=True)
    counts = torch.bincount(dest, minlength=n_shards)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dest.device) - offsets[sorted_dest]
    keep = rank < capacity
    n_slots = n_shards * capacity
    slot = torch.where(keep, sorted_dest * capacity + rank,
                       torch.full_like(rank, n_slots))

    def pack_leaf(x):
        # row n_slots is the spare that takes every dropped row, sliced off
        buf = x.new_zeros((n_slots + 1,) + x.shape[1:])
        return buf.index_put((slot,), x[order])[:n_slots].reshape(
            (n_shards, capacity) + x.shape[1:])

    packed = _map(pack_leaf, payload)
    valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dest.device
                        ).index_put((slot,), keep)[:n_slots]
    slot_of_row = torch.full((n,), n_slots, dtype=torch.int64,
                             device=dest.device)
    slot_of_row[order] = slot
    kept = torch.zeros(n, dtype=torch.bool, device=dest.device)
    kept[order] = keep
    return packed, valid, slot_of_row, kept


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Row block j of (W, ...) `x` goes to rank j; block j of the result
    came from rank j (the reference's all_to_all, split and concat on
    axis 0).  bool and unsigned tensors travel as same-width signed
    views (NCCL and gloo move neither)."""
    if x.dtype == torch.bool:
        return all_to_all(x.view(torch.uint8), group).view(torch.bool)
    src = signed_view(x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.view(x.dtype)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(W, *x.shape): every rank's x in rank order
    (`all_gather_into_tensor`, the name the card's torch has)."""
    world = dist.get_world_size(group)
    src = x.contiguous().reshape(-1)
    out = src.new_empty((world * src.numel(),))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.reshape(world, *x.shape)


class _Exchange(torch.autograd.Function):
    """The all-to-all exchange; its backward sends the gradient back the
    way the rows came (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


class _SumOverRanks(torch.autograd.Function):
    """SUM all-reduce over `group` whose backward passes the gradient
    through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The SUM of `x` over the ranks of `group` (called by every rank).

    Every rank then computes the same loss from the sum, so its backward
    hands each rank the gradient through its own summand, unchanged: a
    rank's parameter gradient is its own part, and their SUM over the
    group (a data-parallel gradient all-reduce) is the gradient of the
    loss on the whole input.  (`torch.distributed.nn.functional.
    all_reduce` sums the gradient in its backward too, which would scale
    that sum by the group's size.)"""
    return _SumOverRanks.apply(x, group)


def route(payload: Any, dest: torch.Tensor, capacity: int, group=None):
    """Send payload rows to the `dest` ranks of `group` (called by every
    rank of the group).

    Returns (recv_payload, routing).  recv leaves have shape
    (n_shards * capacity, ...): row blocks [j*cap:(j+1)*cap] came from rank
    j; invalid rows are zero-filled (mask with routing.recv_valid).
    """
    n_shards = dist.get_world_size(group)
    packed, valid, slot_of_row, kept = _pack(payload, dest, n_shards,
                                             capacity)

    def xchg(x):
        return _Exchange.apply(x, group).reshape((n_shards * capacity,)
                                           + x.shape[2:])

    recv = _map(xchg, packed)
    recv_valid = xchg(valid.reshape(n_shards, capacity))
    return recv, Routing(slot_of_row=slot_of_row, kept=kept,
                         recv_valid=recv_valid, n_shards=n_shards,
                         capacity=capacity)


def send_back(results: Any, routing: Routing, group=None):
    """Inverse exchange: receiver-aligned results -> origin rows.

    results leaves: (n_shards * capacity, ...) aligned with recv layout.
    Returns leaves of shape (N, ...) aligned with the original rows; rows
    dropped by capacity come back as zeros (mask with routing.kept).
    """
    cap, n_shards = routing.capacity, routing.n_shards

    def back(x):
        y = _Exchange.apply(x.reshape((n_shards, cap) + x.shape[1:]), group)
        y = y.reshape((n_shards * cap,) + x.shape[1:])
        padded = torch.cat([y, y.new_zeros((1,) + y.shape[1:])], dim=0)
        return padded[torch.clamp(routing.slot_of_row, max=n_shards * cap)]

    return _map(back, results)


def local_group_by(values: Any, group: torch.Tensor, n_groups: int,
                   capacity: int):
    """Rank-local grouped layout: rows -> (n_groups, capacity, ...) slots.

    Same packing as `route` but without the exchange: it arranges
    received MoE rows per local expert for the batched GEMM.
    Returns (grouped, slot_of_row, kept).
    """
    packed, _, slot_of_row, kept = _pack(values, group, n_groups, capacity)
    return packed, slot_of_row, kept


def ungroup(grouped: Any, slot_of_row: torch.Tensor, n_groups: int,
            capacity: int):
    """Inverse of local_group_by for result rows."""
    def unpack(x):
        flat = x.reshape((n_groups * capacity,) + x.shape[2:])
        padded = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])],
                           dim=0)
        return padded[torch.clamp(slot_of_row, max=n_groups * capacity)]
    return _map(unpack, grouped)
