"""Tiered hot/cold plane storage: a host-resident cold tier past device
memory (PyTorch).

Counterpart of `repro/stream/tiering.py`.  A plane keeps only its
`max_hot_tenants` most active tenants resident in the device `(H, d, w)`
stack (the HOT tier) and parks everyone else in a host-side numpy cold
store in the storage layout (packed where the spec packs).  The device
ring doubles as the per-tenant buffer: a cold tenant's events collect in
the host queue mirror and land through one batched spill a fill class a
flush epoch (`ops.tier_spill`, on the card the update kernels 2 and 5).

Mechanics (`PlaneTier` here, the plane side in `stream/service.py`):

  * The HOST QUEUE MIRROR is the ground truth for ring contents: every
    append stages on the host anyway, so the mirror replays the device
    ring's semantics (append at fill, stale slots persist across flush
    resets) for ALL tenants.  Demotion never reads the device ring back,
    and promotion re-uploads the tenant's mirror row, stale slots
    included, which keeps the dedup sort positions (and with them the
    uniforms each key draws) the same as in an all-resident plane.
  * Promotion and demotion ride the flush's active rows: rows with
    pending fill are the recency signal.  "lru" evicts the hot tenant
    with the oldest last-active epoch, "lfu" the one with the fewest
    active epochs; victims must be idle in the epoch that triggers the
    swap.  A swap costs one gather and its host copy (`ops.tier_demote`)
    plus one scatter (`ops.tier_promote`) an epoch, however many tenants
    swap.
  * The hot-tier flush epoch stays one `update_score_rows` a fill class;
    spills, cold reads and swaps tally under their own op names
    (`tier_spill` / `tier_query` / `tier_demote` / `tier_promote`).

The cold tier's host copies (the spill's round trip, the demotion's
read-back, a cold read's upload) are the design's sanctioned transfers;
a flush epoch with no cold tenant active and no swap planned, and an
append to hot tenants, make none.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import sketch as sk
from repro_torch.core.counters import CounterSpec
from repro_torch.kernels import ops
from repro_torch.kernels.sketch import CHUNK

_POLICIES = ("lru", "lfu")


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Tiering policy for a service's planes.

    max_hot_tenants: device residency cap PER PLANE -- each plane keeps at
    most this many tenants in its hot `(H, d, w)` stack.  policy: victim
    selection among idle hot tenants -- "lru" (oldest last-active flush
    epoch) or "lfu" (fewest active flush epochs).
    """
    max_hot_tenants: int
    policy: str = "lru"

    def __post_init__(self):
        if self.max_hot_tenants < 1:
            raise ValueError("max_hot_tenants must be positive, got "
                             f"{self.max_hot_tenants}")
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown tier policy {self.policy!r}; "
                             f"have {_POLICIES}")


def from_memory(budget_bytes: int, max_hot_tenants: int,
                hot_fraction: float = 0.5, depth: int = 2,
                counter: CounterSpec = CounterSpec(), seed: int = 0x5EED,
                packed: bool = False, policy: str = "lru"
                ) -> tuple[sk.SketchSpec, TierSpec]:
    """Size a (SketchSpec, TierSpec) pair from a TOTAL memory budget:
    `hot_fraction` of it is the device share, and the geometry is derived
    so `max_hot_tenants` resident tables fit it (`SketchSpec.from_memory`
    per tenant, the same aligned rounding down, so the budget is never
    over-allocated).  `tier_memory_bytes` reports the split."""
    if not 0.0 < hot_fraction <= 1.0:
        raise ValueError(f"hot_fraction must be in (0, 1], got "
                         f"{hot_fraction}")
    per_tenant = int(budget_bytes * hot_fraction) // int(max_hot_tenants)
    spec = sk.SketchSpec.from_memory(per_tenant, depth=depth,
                                     counter=counter, seed=seed,
                                     packed=packed)
    return spec, TierSpec(max_hot_tenants=int(max_hot_tenants),
                          policy=policy)


def tier_memory_bytes(spec: sk.SketchSpec, tspec: TierSpec,
                      tenants: int) -> dict:
    """Per-tier memory of `tenants` registered tenants: {"hot": device
    bytes, "cold": host bytes, "total": their sum}, `spec.memory_bytes` a
    table, hot capped at `max_hot_tenants`."""
    hot = min(int(tenants), tspec.max_hot_tenants)
    cold = int(tenants) - hot
    return {"hot": hot * spec.memory_bytes,
            "cold": cold * spec.memory_bytes,
            "total": int(tenants) * spec.memory_bytes}


def fill_classes(fill: np.ndarray, rows: np.ndarray, cap_cols: int
                 ) -> list[tuple[int, np.ndarray]]:
    """Group active rows by their CHUNK-rounded fill: each group's upload
    is padded to ITS OWN rounded fill, so one hot tenant does not inflate
    every other tenant's flush width to the batch max.

    Returns [(cols, rows_of_class)] with cols ascending; `cap_cols` caps
    each class at the ring width.  Rows within a class keep their input
    (ascending) order."""
    if rows.size == 0:
        return []
    rounded = np.minimum(
        int(cap_cols),
        CHUNK * -(-fill[rows].astype(np.int64) // CHUNK))
    return [(int(cols), rows[rounded == cols])
            for cols in np.unique(rounded)]


class PlaneTier:
    """Hot/cold membership + host-side cold store for ONE plane.

    Tenant-indexed host state (full length T, hot rows included, so no
    array's shape depends on membership):

      cold        (T,) + row_shape  storage-layout table copies; rows of
                  HOT tenants are stale (the device stack holds theirs)
                  and are overwritten on demotion.
      hqueue      (T, capw) host mirror of the device ring, the record
                  of every tenant's buffered keys (stale slots persist,
                  as in the device ring).
      hfill       (T,) pending-fill mirror (the device ring's `fill` is
                  its slot-indexed gather).
      last_active (T,) flush-epoch stamp of each tenant's last pending
                  fill; hits (T,) epochs the tenant was active in.

    slot maps tenants to hot slots (-1 = cold); slot_tenant is the
    inverse (hot slot -> tenant row).  The cold store grows by doubling
    a buffer it is a view of, so registering T tenants copies O(T)
    tables, not O(T^2).
    """

    def __init__(self, tspec: TierSpec, row_shape: tuple, storage_dtype,
                 capacity: int):
        self.tspec = tspec
        self.row_shape = tuple(row_shape)
        self.capacity = int(capacity)
        self.capw = ops.ring_width(capacity)
        self.dtype = np.dtype(storage_dtype)
        self.slot = np.zeros((0,), np.int32)
        self.slot_tenant = np.zeros((0,), np.int32)
        self.cold = np.zeros((0,) + self.row_shape, self.dtype)
        self._cold_buf = None
        self.hqueue = np.zeros((0, self.capw), np.uint32)
        self.hfill = np.zeros((0,), np.int64)
        self.last_active = np.zeros((0,), np.int64)
        self.hits = np.zeros((0,), np.int64)
        self.epoch = 0

    @property
    def hot_count(self) -> int:
        return int(self.slot_tenant.size)

    @property
    def cold_count(self) -> int:
        return int(self.slot.size) - self.hot_count

    def _grow_cold(self) -> None:
        """Append one zero row to the cold store (amortized doubling)."""
        n = self.cold.shape[0]
        buf = self._cold_buf
        if buf is None or self.cold.base is not buf or buf.shape[0] == n:
            # a fresh buffer (restore and repack replace `cold` outright)
            buf = np.zeros((max(4, 2 * n),) + self.row_shape, self.dtype)
            buf[:n] = self.cold
            self._cold_buf = buf
        self.cold = buf[:n + 1]

    def add_row(self) -> tuple[int, bool]:
        """Register a tenant; returns (tenant row, goes_hot).  New tenants
        fill the hot tier first (registration order), then overflow cold;
        `CountService.restore` re-applies a snapshot's membership on top
        of this default."""
        row = self.slot.size
        goes_hot = self.hot_count < self.tspec.max_hot_tenants
        self.slot = np.append(self.slot, np.int32(self.hot_count
                                                  if goes_hot else -1))
        if goes_hot:
            self.slot_tenant = np.append(self.slot_tenant, np.int32(row))
        self._grow_cold()
        self.hqueue = np.concatenate(
            [self.hqueue, np.zeros((1, self.capw), np.uint32)])
        self.hfill = np.append(self.hfill, np.int64(0))
        self.last_active = np.append(self.last_active, np.int64(-1))
        self.hits = np.append(self.hits, np.int64(0))
        return row, goes_hot

    def free(self, row: int) -> int:
        return self.capacity - int(self.hfill[row])

    def mirror_append(self, rows: Sequence[int],
                      batches: Sequence[np.ndarray]) -> None:
        """Replay a ring append into the host mirror (the arithmetic the
        device kernel applies: write at fill, advance fill)."""
        for r, b in zip(rows, batches):
            f = int(self.hfill[r])
            self.hqueue[r, f:f + b.size] = b
            self.hfill[r] += b.size

    def pending(self) -> int:
        return int(self.hfill.sum())

    def note_flush(self, active: np.ndarray) -> None:
        """Stamp the recency/frequency signals after a flush epoch landed
        and reset the fill mirror (contents stay, as in the device ring)."""
        self.last_active[active] = self.epoch
        self.hits[active] += 1
        self.epoch += 1
        self.hfill[:] = 0

    def plan_swap(self) -> tuple[np.ndarray, np.ndarray]:
        """(demote_tenants, promote_tenants), equal length, slot-paired.

        Promotion candidates are the cold tenants active in the epoch
        that just landed; victims are hot tenants idle in it, ordered by
        the policy (lru: oldest last_active; lfu: fewest active epochs),
        ties broken by tenant row.  The most frequent candidates take the
        coldest victims' slots."""
        just = self.epoch - 1
        cand = np.flatnonzero((self.slot < 0) & (self.last_active == just))
        victims = np.flatnonzero((self.slot >= 0) & (self.last_active < just))
        n = min(cand.size, victims.size)
        if n == 0:
            empty = np.zeros((0,), np.int64)
            return empty, empty
        # np.lexsort sorts by its LAST key first
        if self.tspec.policy == "lfu":
            vorder = np.lexsort((victims, self.last_active[victims],
                                 self.hits[victims]))
        else:
            vorder = np.lexsort((victims, self.hits[victims],
                                 self.last_active[victims]))
        # most frequent candidates first (recency is equal by construction)
        corder = np.lexsort((cand, -self.hits[cand]))
        return victims[vorder][:n], cand[corder][:n]

    def swap(self, demote: np.ndarray, promote: np.ndarray) -> None:
        """Update the membership maps after the device swap: promote[i]
        takes demote[i]'s hot slot."""
        slots = self.slot[demote].copy()
        self.slot[demote] = -1
        self.slot[promote] = slots
        self.slot_tenant[slots] = promote

    def load_membership(self, slot_tenant, last_active, hits,
                        epoch: int) -> None:
        """Re-apply a snapshot's tier membership (checkpoint restore): the
        saved slot->tenant map replaces the registration-order default."""
        st = np.asarray(slot_tenant, np.int32)
        if st.size != self.slot_tenant.size:
            raise ValueError(f"snapshot names {st.size} hot slots, plane "
                             f"has {self.slot_tenant.size}")
        self.slot[:] = -1
        self.slot[st] = np.arange(st.size, dtype=np.int32)
        self.slot_tenant = st.copy()
        self.last_active = np.asarray(last_active, np.int64).copy()
        self.hits = np.asarray(hits, np.int64).copy()
        self.epoch = int(epoch)

    def meta(self) -> dict:
        return {"max_hot_tenants": self.tspec.max_hot_tenants,
                "policy": self.tspec.policy,
                "slot_tenant": [int(s) for s in self.slot_tenant],
                "last_active": [int(v) for v in self.last_active],
                "hits": [int(v) for v in self.hits],
                "epoch": self.epoch}
