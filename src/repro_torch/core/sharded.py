"""Distributed sketches on `torch.distributed` (PyTorch).

Counterpart of `repro/core/sharded.py`.  Two deployment modes:

  * REPLICATED-LAZY -- every data-parallel worker owns a full local
    sketch, updates it every step, and the fleet max-merges
    (`all_reduce(MAX)`) every `merge_every` steps.  The merge is
    associative and commutative, so a merged table is a valid
    conservative-update sketch of the union stream.
  * KEY-ROUTED -- the key space is partitioned over the group's ranks by
    a routing hash; each rank owns a full (d, w) sketch (or bucket ring)
    for its partition.  Updates and queries are dispatched with a
    fixed-capacity `all_to_all_single` (MoE-style), so every collective
    keeps a static shape.

Every function is called by every rank of `group` (default: the world
group), as the reference's are inside `shard_map` over an axis; `group`
takes the place of the reference's axis names.  The tensors live on the
sketch's device: CUDA tensors under NCCL, CPU tensors under gloo
(`launch/mesh.init_group`).  Collectives move int32 / int64 / float32 /
uint8 views: `all_reduce` refuses uint16, so a max runs on the LOGICAL
cell states widened to int32 (int64 for 32-bit cells) and repacks, as the
reference unpacks packed lanes around `pmax` (a max over packed lanes is
not the per-cell max).

The reference runs these functions inside `shard_map`, so under
`jax.jit`: the updates take the jitted float graph (`eager=False`), and
reads go through `ops.query` and the window-query kernels, which compute
it.  `tier_assemble` rebuilds a tiered plane's tenant-ordered stack.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import admission, staging, topk
from repro_torch.core import sketch as sk
from repro_torch.core.counters import from_i64, signed_view
from repro_torch.core.hashing import as_i64, mix32
from repro_torch.routing import all_gather, all_to_all

SENTINEL = 0xFFFF_FFFF
_ROUTE_SALT = 0x60D5


def _world(group) -> int:
    return dist.get_world_size(group)


# --------------------------------------------------------------------------
# replicated-lazy mode
# --------------------------------------------------------------------------

def _pmax_states(states: torch.Tensor, spec: sk.SketchSpec,
                 group) -> torch.Tensor:
    """Elementwise max over the group of int64 logical states, reduced on
    int32 (int64 for 32-bit cells)."""
    wide = torch.int64 if spec.counter.bits == 32 else torch.int32
    buf = states.to(wide)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf.to(torch.int64)


def pmax_merge_window_stack(tables: torch.Tensor, spec: sk.SketchSpec,
                            group=None) -> torch.Tensor:
    """Max-merge any leading-dim stack of storage tables (a (B, d, w)
    ring, the native (T, B, d, w) window-plane leaf) across the group in
    ONE collective: unpack, max, repack."""
    states = sk.logical_table(tables, spec)
    return sk.storage_table(_pmax_states(states, spec, group), spec)


def pmax_merge(sketch: sk.Sketch, group=None) -> sk.Sketch:
    """Max-merge every rank's local sketch across the group."""
    return sk.Sketch(table=pmax_merge_window_stack(sketch.table, sketch.spec,
                                                   group),
                     spec=sketch.spec)


def _merge_step(step: int, merge_every: int) -> bool:
    return step % merge_every == merge_every - 1


def lazy_update(sketch: sk.Sketch, keys, rng, step: int, merge_every: int,
                group=None) -> sk.Sketch:
    """Local update, plus the fleet merge on every `merge_every`-th step
    (`step` is the replicated host step counter, so every rank takes the
    same branch and the collective runs only when it merges)."""
    sketch = sk.update_batched(sketch, keys, rng, eager=False)
    return pmax_merge(sketch, group) if _merge_step(step, merge_every) \
        else sketch


def tier_assemble(hot_tables: torch.Tensor, slot_tenant,
                  cold_tables: torch.Tensor) -> torch.Tensor:
    """A tiered plane's full tenant-ordered stack: the (H, ...) hot slots
    copied into cold_tables, the (T, ...) cold store already uploaded to
    the hot stack's device, at their tenant rows (`slot_tenant`, hot slot
    -> tenant row), ONE `index_copy_` in place.  Returns cold_tables,
    now the all-resident layout."""
    st = np.asarray(slot_tenant, np.int64).reshape(-1)
    if st.size:
        idx = staging.upload(hot_tables.device, st)[0]
        signed_view(cold_tables).index_copy_(0, idx, signed_view(hot_tables))
    return cold_tables


def pmax_merge_tier_stack(hot_tables: torch.Tensor, slot_tenant,
                          cold_tables: torch.Tensor, spec: sk.SketchSpec,
                          group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-merge a TIERED plane across the group: assemble the full
    (T, ...) tenant stack from both tiers (`tier_assemble`, in place into
    the uploaded `cold_tables`), merge it like `pmax_merge`, and return
    (merged hot slice, merged full stack).  Ranks must agree on tier
    membership."""
    stack = tier_assemble(hot_tables, slot_tenant, cold_tables)
    merged = pmax_merge_window_stack(stack, spec, group)
    idx = torch.as_tensor(np.asarray(slot_tenant, np.int64).reshape(-1),
                          device=merged.device)
    return signed_view(merged)[idx].view(merged.dtype), merged


def pmax_merge_window(win, group=None):
    """Max-merge every rank's bucket ring bucket-wise (ranks rotate on the
    same schedule, so bucket b is the same time slice on every rank): the
    one-ring case of `pmax_merge_window_stack`."""
    return dataclasses.replace(
        win, tables=pmax_merge_window_stack(win.tables, win.spec.sketch,
                                            group))


def lazy_update_window(win, keys, rng, step: int, merge_every: int,
                       group=None):
    """Windowed `lazy_update`: a local active-bucket update plus the
    periodic bucket-wise fleet merge."""
    from repro_torch.stream import window as w  # stream imports core
    win = w.window_update(win, keys, rng, eager=False)
    return pmax_merge_window(win, group) if _merge_step(step, merge_every) \
        else win


# --------------------------------------------------------------------------
# key-routed mode
# --------------------------------------------------------------------------

def route_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owning rank of each key (independent of the row hashes), int32."""
    return (mix32(as_i64(keys) ^ _ROUTE_SALT) % n_shards).to(torch.int32)


def _dispatch_layout(keys: torch.Tensor, n_shards: int, capacity: int):
    """Pack keys into an (n_shards, capacity) uint32 send buffer, grouped
    by owning rank in arrival order (a stable sort), SENTINEL-filled.

    Returns (buffer, slot_of_key int32, kept bool): keys past `capacity`
    for one rank are dropped, and their slot is the overflow marker
    n_shards * capacity."""
    k = as_i64(keys).reshape(-1)
    n, total = k.numel(), n_shards * capacity
    dest = route_of(k, n_shards).to(torch.int64)
    order = torch.sort(dest, stable=True).indices
    sorted_dest = dest[order]
    counts = torch.bincount(dest, minlength=n_shards)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=k.device) - offsets[sorted_dest]
    keep = rank < capacity
    slot = torch.where(keep, sorted_dest * capacity + rank,
                       torch.full_like(rank, total))
    buf = torch.full((total + 1,), SENTINEL, dtype=torch.int64,
                     device=k.device)
    buf[slot] = k[order]  # overflow lands in the extra slot, then drops
    slot_of_key = torch.empty_like(slot)
    slot_of_key[order] = slot
    kept = torch.empty_like(keep)
    kept[order] = keep
    return (from_i64(buf[:total], torch.uint32).reshape(n_shards, capacity),
            slot_of_key.to(torch.int32), kept)


def _received(local_device, keys, capacity: int, group):
    """Dispatch keys to their owning ranks: (flat received uint32 probes,
    slot_of_key, kept, n_shards)."""
    from repro_torch.kernels import ops  # kernels import core
    n_shards = _world(group)
    keys = ops.as_device_keys(keys, local_device)
    buf, slot_of_key, kept = _dispatch_layout(keys, n_shards, capacity)
    return all_to_all(buf, group).reshape(-1), slot_of_key, kept, n_shards


def _valid_weights(flat: torch.Tensor) -> torch.Tensor:
    """Weight 1 a received key, 0 a SENTINEL fill slot (a no-op)."""
    return (as_i64(flat) != SENTINEL).to(torch.float32)


def routed_update(local: sk.Sketch, keys, rng, capacity: int,
                  group=None) -> sk.Sketch:
    """Update this rank's partition of a key-routed sketch with the keys
    every rank routes to it."""
    flat, _, _, _ = _received(local.table.device, keys, capacity, group)
    return sk.update_batched(local, flat, rng, weights=_valid_weights(flat),
                             eager=False)


def _route_estimates_back(est: torch.Tensor, recv_keys: torch.Tensor,
                          slot_of_key: torch.Tensor, kept: torch.Tensor,
                          n_shards: int, capacity: int,
                          group=None) -> torch.Tensor:
    """Return each rank's answers to the ranks that asked, aligned with
    their original keys: fill probes answer 0, and keys dropped by the
    capacity come back as -1.0."""
    est = torch.where(as_i64(recv_keys) == SENTINEL,
                      torch.zeros_like(est), est)
    back = all_to_all(est.reshape(n_shards, capacity), group).reshape(-1)
    padded = torch.cat([back, back.new_full((1,), -1.0)])
    out = padded[torch.clamp_max(slot_of_key.to(torch.int64),
                                 n_shards * capacity)]
    return torch.where(kept, out, torch.full_like(out, -1.0))


def routed_query(local: sk.Sketch, keys, capacity: int,
                 group=None) -> torch.Tensor:
    """Query a key-routed sketch (`ops.query` on each rank's partition);
    float32 estimates aligned with `keys`, -1.0 where the capacity
    dropped a key."""
    from repro_torch.kernels import ops
    flat, slot_of_key, kept, n = _received(local.table.device, keys,
                                           capacity, group)
    return _route_estimates_back(ops.query(local, flat), flat, slot_of_key,
                                 kept, n, capacity, group)


# --------------------------------------------------------------------------
# key-routed windows: each rank owns a full ring for its key partition,
# and every rank rotates on the same schedule, so bucket b is the same
# time slice fleet-wide
# --------------------------------------------------------------------------

def routed_window_update(win, keys, rng, capacity: int, group=None,
                         epoch: int | None = None):
    """Update this rank's partition of a key-routed bucket ring.

    epoch: the batch's event-time interval index (replicated, a host
    int).  When given, every rank first advances its ring by
    max(epoch - win.epoch, 0) rotations (a stale epoch is a no-op, not an
    error inside the collective); the ring needs a watermark
    (`window_init(spec, epoch=...)`)."""
    from repro_torch.stream import window as w
    if epoch is not None:
        if win.epoch is None:
            raise ValueError("epoch-driven routed updates need a ring with "
                             "an initialized watermark: window_init(spec, "
                             "epoch=...)")
        win = w.window_advance_steps(win, max(int(epoch) - win.epoch, 0))
    flat, _, _, _ = _received(win.tables.device, keys, capacity, group)
    return w.window_update(win, flat, rng, weights=_valid_weights(flat),
                           eager=False)


def _gathered_candidates(tracker: topk.TopK, group=None):
    """Every rank's (K,) tracker row gathered into flat (W * K,) keys,
    estimates and filled mask, in rank order."""
    keys = all_gather(signed_view(tracker.keys), group).reshape(-1)
    est = all_gather(tracker.estimates, group).reshape(-1)
    filled = all_gather(tracker.filled.to(torch.uint8), group).reshape(-1)
    return keys.view(torch.uint32), est, filled.to(torch.bool)


def routed_topk(tracker: topk.TopK, group=None,
                k: int | None = None) -> topk.TopK:
    """Fleet-wide heavy hitters over key-routed ranks: every rank's local
    tracker (authoritative for its disjoint key partition) gathered and
    re-selected by estimate (ties: the lower rank and slot first, as
    `lax.top_k`).  Returns the same (k,) TopK on every rank."""
    k = tracker.keys.shape[0] if k is None else int(k)
    keys, est, filled = _gathered_candidates(tracker, group)
    est = torch.where(filled, est, torch.full_like(est, -torch.inf))
    top_est, idx = torch.sort(est, descending=True, stable=True)
    top_est, idx = top_est[:k].contiguous(), idx[:k]
    return topk.TopK(keys=signed_view(keys)[idx].view(torch.uint32),
                     estimates=top_est, filled=top_est > -torch.inf)


def routed_admit(tracker: topk.TopK, ids, spec: admission.AdmissionSpec,
                 group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Tracker-fed admission over key-routed ranks: the gathered
    candidates of every rank are the fleet's hot set, and each id is
    admitted iff it matches one whose estimate clears `spec.threshold`
    (`admission.admit_tracked`).  (rows, admitted) aligned with this
    rank's ids, the same decisions on every rank."""
    keys, est, filled = _gathered_candidates(tracker, group)
    return admission.admit_tracked(keys, est, filled, ids, spec)


def merged_metrics(values: torch.Tensor, group=None,
                   mode: str = "sum") -> torch.Tensor:
    """Fleet-wide reduction of every rank's flat metric values: gathered
    in rank order, then summed (counters, histogram buckets) or maxed
    (gauges, high-water marks)."""
    if mode not in ("sum", "max"):
        raise ValueError(f"unknown metric merge mode: {mode!r}")
    out = all_gather(values, group)
    return out.sum(dim=0) if mode == "sum" else out.max(dim=0).values


def routed_window_query(win, keys, capacity: int, group=None,
                        n_buckets: int | None = None, mode: str = "sum",
                        gamma: float | None = None,
                        engine: str = "auto") -> torch.Tensor:
    """Query a key-routed bucket ring: each rank answers its partition's
    keys with ONE window-query launch (`stream.window.window_query`,
    bucket weights and gamma^age decay in the kernel), then the answers
    route back; -1.0 where the capacity dropped a key."""
    from repro_torch.stream import window as w
    flat, slot_of_key, kept, n = _received(win.tables.device, keys,
                                           capacity, group)
    est = w.window_query(win, flat, n_buckets=n_buckets, mode=mode,
                         gamma=gamma, engine=engine)
    return _route_estimates_back(est, flat, slot_of_key, kept, n, capacity,
                                 group)
