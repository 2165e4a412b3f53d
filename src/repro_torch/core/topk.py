"""Heavy-hitter tracking on top of a sketch (PyTorch).

Counterpart of `repro/core/topk.py`.  A fixed-size (T, K) candidate
buffer of (key, estimate) pairs per tenant is refreshed with each flush:
the standing heap joins the flushed batch (`candidates`), every
candidate is scored against the updated table, and the union is
re-selected (`reselect`).  `resize_stacked` re-arms a heap stack at
another width (restore with a changed track_top).  `init` / `refresh`
serve one sketch: a (k,) buffer, the T = 1 case scored by `sk.query`.

Slot occupancy is an explicit `filled` mask, not a sentinel key: every
uint32 value, 0xFFFFFFFF included, is a trackable key, and unfilled
slots (estimate -inf) never claim a key's identity during dedup.

Ordering matches the reference bit for bit: `jnp.lexsort` becomes two
stable sorts (secondary key first), and `jax.lax.top_k`, which puts the
lower index first among ties, becomes a stable descending sort (torch's
`topk` promises no order among ties).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sketch as sk
from repro_torch.core.counters import from_i64, signed_view
from repro_torch.core.device import resolve_device
from repro_torch.core.hashing import as_i64


@dataclasses.dataclass
class TopK:
    keys: torch.Tensor       # (t, k) uint32 candidate keys
    estimates: torch.Tensor  # (t, k) float32 (-inf in unfilled slots)
    filled: torch.Tensor     # (t, k) bool occupancy mask


def init_stacked(t: int, k: int, device=None) -> TopK:
    """Cold (t, k) heap stack -- one top-k buffer per tenant row, on
    `device`: CUDA unless the caller passes "cpu"
    (`core/device.resolve_device`)."""
    device = resolve_device(device)
    return TopK(keys=torch.zeros((t, k), dtype=torch.int32,
                                 device=device).view(torch.uint32),
                estimates=torch.full((t, k), -torch.inf, dtype=torch.float32,
                                     device=device),
                filled=torch.zeros((t, k), dtype=torch.bool, device=device))


def init(k: int, device=None) -> TopK:
    """Cold single-sketch buffer: (k,) keys, estimates and filled, on
    `device` (CUDA unless the caller passes "cpu")."""
    one = init_stacked(1, k, device)
    return TopK(keys=one.keys[0], estimates=one.estimates[0],
                filled=one.filled[0])


def _select(cand: torch.Tensor, valid: torch.Tensor, est: torch.Tensor,
            k: int):
    """Row-wise top-k over candidate unions (R, M): mask invalid, dedup
    (valid entries outrank invalid placeholders among equal keys), then
    select.  Returns (keys int64, estimates, filled), each (R, k)."""
    keys = as_i64(cand)
    neg_inf = torch.full_like(est, -torch.inf)
    est = torch.where(valid, est, neg_inf)
    # lexsort((~valid, keys)): stable sort by the secondary key, then by
    # the primary key
    o1 = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(keys, -1, o1), dim=-1, stable=True).indices
    order = torch.gather(o1, -1, o2)
    sorted_keys = torch.gather(keys, -1, order)
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    keep = torch.zeros_like(first).scatter_(-1, order, first)
    est = torch.where(keep, est, neg_inf)
    top_est, idx = torch.sort(est, dim=-1, descending=True, stable=True)
    top_est, idx = top_est[..., :k], idx[..., :k]
    filled = top_est > -torch.inf  # estimates are decoded counts, >= 0
    return torch.gather(keys, -1, idx), top_est, filled


def candidates(tracker: TopK, batch_keys: torch.Tensor,
               batch_valid: torch.Tensor | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cand (T, K+N) uint32 keys, valid (T, K+N) mask): each row's
    standing heap joined with its batch."""
    batch = from_i64(as_i64(batch_keys), torch.uint32)
    cand = torch.cat([signed_view(tracker.keys), signed_view(batch)],
                     dim=1).view(torch.uint32)
    if batch_valid is None:
        batch_valid = torch.ones(batch_keys.shape, dtype=torch.bool,
                                 device=batch_keys.device)
    valid = torch.cat([tracker.filled, batch_valid], dim=1)
    return cand, valid


def reselect(cand: torch.Tensor, valid: torch.Tensor, est: torch.Tensor,
             k: int) -> TopK:
    """Select the new (T, k) heaps from scored candidates; `est` must
    hold every candidate's CURRENT estimate."""
    keys, est, filled = _select(cand, valid, est, k)
    return TopK(keys=from_i64(keys, torch.uint32), estimates=est,
                filled=filled)


def refresh_stacked(tracker: TopK, batch_keys: torch.Tensor,
                    batch_valid: torch.Tensor | None, score_fn) -> TopK:
    """Refresh a (T, K) heap stack against per-tenant batches; score_fn
    maps (T, K+N) candidate keys -> (T, K+N) float32 estimates."""
    cand, valid = candidates(tracker, batch_keys, batch_valid)
    return reselect(cand, valid, score_fn(cand), tracker.keys.shape[1])


def resize_stacked(tracker: TopK, k: int) -> TopK:
    """Re-arm a (T, K) heap stack at width k.

    Shrinking keeps each row's best k candidates by stored estimate
    (unfilled slots count as -inf; ties keep the lower slot first, as
    `jax.lax.top_k` does); growing keeps every standing candidate and
    appends cold slots."""
    t, old = tracker.keys.shape
    if k == old:
        return tracker
    if k > old:
        pad = init_stacked(t, k - old, tracker.keys.device)
        return TopK(
            keys=torch.cat([signed_view(tracker.keys), signed_view(pad.keys)],
                           dim=1).view(torch.uint32),
            estimates=torch.cat([tracker.estimates, pad.estimates], dim=1),
            filled=torch.cat([tracker.filled, pad.filled], dim=1))
    est = torch.where(tracker.filled, tracker.estimates,
                      torch.full_like(tracker.estimates, -torch.inf))
    top_est, idx = torch.sort(est, dim=1, descending=True, stable=True)
    top_est, idx = top_est[:, :k].contiguous(), idx[:, :k]
    keys = torch.gather(signed_view(tracker.keys), 1, idx)
    return TopK(keys=keys.view(torch.uint32), estimates=top_est,
                filled=top_est > -torch.inf)


def refresh(tracker: TopK, sketch: sk.Sketch, batch_keys: torch.Tensor,
            batch_valid: torch.Tensor | None = None) -> TopK:
    """Single-sketch refresh, the T = 1 case of `refresh_stacked`: the
    (k,) buffer joins `batch_keys` (N,) and every candidate is scored by
    `sk.query` on `sketch`'s current table."""
    out = refresh_stacked(
        TopK(keys=tracker.keys[None], estimates=tracker.estimates[None],
             filled=tracker.filled[None]),
        batch_keys[None],
        None if batch_valid is None else batch_valid[None],
        lambda ck: sk.query(sketch, ck.reshape(-1)).reshape(ck.shape))
    return TopK(keys=out.keys[0], estimates=out.estimates[0],
                filled=out.filled[0])
