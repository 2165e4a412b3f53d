"""Time-scoped sketches: sliding-window bucket ring + exponential decay
(PyTorch).

Counterpart of `repro/stream/window.py`.  Two constructions, both on the
paper's counters unchanged:

  * `WindowedSketch` -- a ring of B bucket tables of one `SketchSpec`.
    The active bucket (the cursor) absorbs updates (`window_update`); the
    ring advances on caller cadence (`window_rotate`) or, with
    `WindowSpec.interval` set, from event timestamps (`window_advance_to`,
    watermarks), zeroing the buckets rotation reuses, so bucket b holds
    exactly the events of one interval.  A window query over the last k
    buckets combines the per-bucket estimates in ONE kernel launch
    (`kernels.ops.window_query_tables`):
      - mode="sum" (default): each bucket's estimate (min over rows,
        decode) weighted and summed in bucket order -- the union-count
        estimator;
      - mode="max": the largest weighted bucket estimate;
      - gamma: lazy decay -- bucket b's estimate is weighted by
        gamma^age at query time, never in the stored counters.

  * `DecayedSketch` -- recency-weighted counts on ONE (B+1, d, w) leaf:
    the ring's buckets at [:B] hold the last B rotations' events
    undecayed, the tail at [B] all older mass.  Updates are plain
    conservative updates into the age-0 bucket; `decayed_rotate` folds
    only the expiring bucket into the tail (decode, add, stochastic
    re-encode: unbiased); `decayed_query` weights bucket b by gamma^age
    and the tail by gamma^B in one launch of the same kernel.  `decay`
    is the eager form: every cell's estimate times gamma, re-encoded.

`window_init`, `window_update`, `window_rotate`, `window_advance_to`,
`decay` and the decayed functions return new objects, as the reference
does.  `CountService`'s window planes keep every tenant's ring in one
(T, B, d, w) leaf and hand out `WindowedSketch` views of it; a tiered
plane's cold tenants keep their rings in host memory and rotate them
with `cold_advance`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import sketch as sk
from repro_torch.core import staging, xla_f32
from repro_torch.core.counters import f32_const, signed_view, zeros
from repro_torch.core.device import resolve_device
from repro_torch.core.sketch import Sketch, SketchSpec
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Static geometry of a bucket ring: B buckets of one SketchSpec.

    interval > 0 enables watermark-driven rotation: each bucket covers
    `interval` timestamp units.  interval == 0 means caller-cadence
    rotation only.
    """

    sketch: SketchSpec
    buckets: int = 8
    interval: float = 0.0

    def __post_init__(self):
        if self.buckets < 1:
            raise ValueError("need at least one bucket")
        if self.interval < 0:
            raise ValueError("interval must be >= 0")

    @property
    def memory_bytes(self) -> int:
        return self.buckets * self.sketch.memory_bytes


@dataclasses.dataclass
class WindowedSketch:
    tables: torch.Tensor  # (B, d, w) bucket counter states
    cursor: int           # index of the active (newest) bucket
    spec: WindowSpec
    # watermark: the interval index (floor(ts / interval)) the active
    # bucket covers; None until the first timestamped event
    epoch: int | None = None

    def bucket(self, b: int) -> Sketch:
        """View bucket b as a plain Sketch (shares the table slice)."""
        return Sketch(table=self.tables[b], spec=self.spec.sketch)


def window_init(spec: WindowSpec, epoch: int | None = None,
                device=None) -> WindowedSketch:
    """A fresh ring on `device` (CUDA unless the caller passes "cpu",
    `core/device.resolve_device`).  `epoch` pre-seeds the watermark (the
    interval index of the active bucket)."""
    s = spec.sketch
    tables = zeros((spec.buckets, s.depth, s.storage_width),
                   s.storage_dtype, resolve_device(device))
    return WindowedSketch(tables=tables, cursor=0, spec=spec,
                          epoch=None if epoch is None else int(epoch))


def _set_bucket(tables: torch.Tensor, b: int, table) -> torch.Tensor:
    """A copy of the leaf `tables` with bucket b replaced by `table` (or
    zeroed when `table` is None)."""
    out = tables.clone()
    if table is None:
        signed_view(out)[b] = 0
    else:
        signed_view(out)[b] = signed_view(table)
    return out


def window_update(win: WindowedSketch, keys, rng, weights=None,
                  eager: bool = True) -> WindowedSketch:
    """Conservative-update the active bucket (`sk.update_batched`, whose
    `eager` picks the float graph of the reference's call)."""
    s = sk.update_batched(win.bucket(win.cursor), keys, rng,
                          weights=weights, eager=eager)
    return dataclasses.replace(
        win, tables=_set_bucket(win.tables, win.cursor, s.table))


def window_rotate(win: WindowedSketch) -> WindowedSketch:
    """Advance the ring one interval: the oldest bucket becomes the new
    (zeroed) active bucket."""
    nxt = (win.cursor + 1) % win.spec.buckets
    return dataclasses.replace(win, tables=_set_bucket(win.tables, nxt, None),
                               cursor=nxt)


def interval_epoch(spec: WindowSpec, ts) -> int:
    """Interval index (watermark epoch) owning event timestamp `ts`."""
    if spec.interval <= 0:
        raise ValueError("event-time epochs need WindowSpec.interval > 0")
    return int(math.floor(float(ts) / spec.interval))


def interval_lag(spec: WindowSpec, epoch: int | None, ts) -> int:
    """Whole intervals event-time `ts` runs ahead of a ring whose
    watermark interval is `epoch` (0 = same interval, or no watermark
    yet): the per-tenant watermark-lag gauge."""
    if epoch is None:
        return 0
    return max(0, interval_epoch(spec, ts) - int(epoch))


def window_advance_steps(win: WindowedSketch, steps: int) -> WindowedSketch:
    """Advance the ring `steps` >= 0 rotations in one masked zeroing (as
    `steps` successive single rotations would); returns a new ring, the
    epoch (when set) advanced by `steps`."""
    b = win.spec.buckets
    steps = int(steps)
    cleared = np.flatnonzero(ops.rotation_mask([win.cursor], [steps], b)[0])
    tables = win.tables.clone()
    signed_view(tables)[torch.from_numpy(cleared).to(tables.device)] = 0
    epoch = None if win.epoch is None else win.epoch + steps
    return dataclasses.replace(win, tables=tables,
                               cursor=(win.cursor + steps) % b, epoch=epoch)


def window_advance_to(win: WindowedSketch, ts) -> WindowedSketch:
    """Watermark-driven rotation: advance the ring to the bucket owning
    event time `ts` (0..B rotations; a full ring or more zeroes every
    bucket).  Timestamps may jitter within one interval, but one behind
    the ring's watermark interval raises."""
    epoch = interval_epoch(win.spec, ts)
    if win.epoch is None:
        return dataclasses.replace(win, epoch=epoch)
    have = int(win.epoch)
    if epoch < have:
        raise ValueError(
            f"non-monotone watermark: ts {ts} (interval {epoch}) is behind "
            f"the ring's watermark interval {have}")
    steps = epoch - have
    if steps == 0:
        return win
    return dataclasses.replace(window_advance_steps(win, steps), epoch=epoch)


def cold_advance(tables: np.ndarray, cursor: int, steps: int) -> np.ndarray:
    """Watermark rotation of a COLD tenant's host (B, d, w) ring, IN
    PLACE: the buckets `ops.rotation_mask` clears for this ring (the
    `steps` after `cursor`, every one when steps >= B) are zeroed, so a
    ring rotates the same way whichever tier it lives in.  Returns
    `tables` (the reference returns a rotated copy; zeroing in place
    writes only the cleared buckets of the cold store).  The caller owns
    the cursor mirror."""
    tables[ops.rotation_mask([cursor], [steps], tables.shape[0])[0]] = 0
    return tables


def window_weights_host(cursors, buckets: int,
                        n_buckets: int | None = None,
                        gamma: float | None = None) -> np.ndarray:
    """(R, B) float32 per-bucket estimate weights for R rings of one
    geometry, on the host: 0 past the last `n_buckets` intervals, else 1,
    or gamma^age with lazy decay (one evaluation for every ring).  The
    reference's `jnp.float32(gamma) ** age`, bit for bit (`xla_f32.pow`:
    XLA's CPU calls `powf`)."""
    k = buckets if n_buckets is None else n_buckets
    if not 1 <= k <= buckets:
        raise ValueError(f"window of {k} buckets outside ring of {buckets}")
    cursors = np.asarray(cursors, np.int64).reshape(-1, 1)
    ages = (cursors - np.arange(buckets)[None, :]) % buckets
    live = (ages < k).astype(np.float32)
    if gamma is not None:
        if not 0.0 < gamma <= 1.0:
            raise ValueError("gamma must be in (0, 1]")
        live = live * xla_f32.pow(gamma, ages)
    return live


def window_weights_stacked(cursors, buckets: int,
                           n_buckets: int | None = None,
                           gamma: float | None = None,
                           device="cpu") -> torch.Tensor:
    """`window_weights_host` placed on `device` without a synchronize
    (`core/staging.py`)."""
    return staging.upload(device, window_weights_host(
        cursors, buckets, n_buckets, gamma))[0]


def window_weights(win: WindowedSketch, n_buckets: int | None = None,
                   gamma: float | None = None) -> torch.Tensor:
    """(B,) float32 weights `window_query` applies to one ring."""
    return window_weights_stacked([win.cursor], win.spec.buckets, n_buckets,
                                  gamma, device=win.tables.device)[0]


def window_query(win: WindowedSketch, keys, n_buckets: int | None = None,
                 mode: str = "sum", gamma: float | None = None,
                 engine: str = "auto") -> torch.Tensor:
    """Estimated counts over the last `n_buckets` intervals (default the
    whole ring), optionally gamma^age decayed: ONE launch.  float32 (N,)."""
    return ops.window_query_tables(win.tables, win.spec.sketch, keys,
                                   window_weights(win, n_buckets, gamma),
                                   mode=mode, engine=engine)


def window_query_many(wins: list, keys, n_buckets: int | None = None,
                      mode: str = "sum", gamma: float | None = None,
                      engine: str = "auto") -> torch.Tensor:
    """R rings sharing one WindowSpec, keys (R, N): ONE stacked launch,
    row r equal to `window_query(wins[r], keys[r])`.  float32 (R, N)."""
    if not wins:
        raise ValueError("need at least one ring")
    if any(x.spec != wins[0].spec for x in wins[1:]):
        specs = sorted({str(x.spec) for x in wins})
        raise ValueError("window_query_many needs rings sharing one "
                         f"WindowSpec; got {specs}")
    tables = wins[0].tables
    rings = torch.stack([signed_view(x.tables) for x in wins]).view(
        tables.dtype)
    weights = window_weights_stacked([x.cursor for x in wins],
                                     wins[0].spec.buckets, n_buckets, gamma,
                                     device=tables.device)
    return ops.window_query_stacked(rings, wins[0].spec.sketch, keys,
                                    weights, mode=mode, engine=engine)


# --------------------------------------------------------------------------
# exponential decay in estimate space
# --------------------------------------------------------------------------

def _check_gamma(gamma: float) -> None:
    if not 0.0 < gamma <= 1.0:
        raise ValueError("gamma must be in (0, 1]")


def decay(sketch: Sketch, gamma: float, rng) -> Sketch:
    """Scale every cell's estimate by gamma with a stochastic re-encode
    (`CounterSpec.reencode_stochastic`, `rng` a raw key): E[decode(new)]
    == gamma * decode(old) cell for cell.  Works on the logical cells
    (packed storage unpacks first)."""
    _check_gamma(gamma)
    c = sketch.spec.counter
    states = sk.logical_table(sketch.table, sketch.spec)
    v = c.decode_eager(states) * f32_const(gamma, states.device)
    table = sk.storage_table(c.cells(c.reencode_stochastic(v, rng)),
                             sketch.spec)
    return Sketch(table=table, spec=sketch.spec)


@dataclasses.dataclass
class DecayedSketch:
    """Recency-weighted counts: events of age a (in rotations) carry
    weight gamma^a.  ONE (B+1, d, w) leaf: the ring's buckets at [:B]
    hold the last B rotations' events undecayed, the tail at [B] all
    older mass, so that gamma^B * decode(tail) is its query-time share.
    `win` / `tail` are views of the leaf."""

    tables: torch.Tensor  # (B+1, d, w): last B rotations' buckets + tail
    cursor: int           # active (age-0) ring bucket
    spec: WindowSpec      # ring geometry (B buckets)
    gamma: float

    @property
    def win(self) -> WindowedSketch:
        """Ring view over the leaf's first B buckets."""
        return WindowedSketch(tables=self.tables[:self.spec.buckets],
                              cursor=self.cursor, spec=self.spec)

    @property
    def tail(self) -> torch.Tensor:
        """(d, w) view of the older-than-the-ring mass (bucket B)."""
        return self.tables[self.spec.buckets]


def decayed_init(spec: SketchSpec, gamma: float = 0.98, history: int = 8,
                 device=None) -> DecayedSketch:
    """`history` = ring depth B: ages 0..B-1 are queried from their own
    bucket, older mass from the shared tail.  On `device`: CUDA unless
    the caller passes "cpu"."""
    _check_gamma(gamma)
    tables = zeros((history + 1, spec.depth, spec.storage_width),
                   spec.storage_dtype, resolve_device(device))
    return DecayedSketch(tables=tables, cursor=0,
                         spec=WindowSpec(sketch=spec, buckets=history),
                         gamma=gamma)


def decayed_rotate(ds: DecayedSketch, rng) -> DecayedSketch:
    """Age every event one rotation: fold ONLY the expiring bucket into
    the tail (V' = V_expiring + gamma * V_tail, one decode, add and
    stochastic re-encode of a (d, w) table), then zero it as the new
    active bucket."""
    b = ds.spec.buckets
    spec = ds.spec.sketch
    c = spec.counter
    nxt = (ds.cursor + 1) % b
    expiring = sk.logical_table(ds.tables[nxt], spec)
    tail = sk.logical_table(ds.tail, spec)
    v = (c.decode_eager(expiring)
         + f32_const(ds.gamma, tail.device) * c.decode_eager(tail))
    folded = sk.storage_table(c.cells(c.reencode_stochastic(v, rng)), spec)
    tables = _set_bucket(ds.tables, b, folded)
    signed_view(tables)[nxt] = 0
    return dataclasses.replace(ds, tables=tables, cursor=nxt)


def decayed_update(ds: DecayedSketch, keys, rng, weights=None,
                   age_step: bool = True) -> DecayedSketch:
    """Absorb a batch at age 0, by default aging the ring one step first
    (one batch == one rotation); age_step=False micro-batches within one
    rotation interval.  `rng` splits into the rotation's and the
    update's keys (`prng.split`, as the reference's)."""
    r_rot, r_upd = prng.split(rng, 2)
    if age_step:
        ds = decayed_rotate(ds, r_rot)
    s = sk.update_batched(Sketch(table=ds.tables[ds.cursor],
                                 spec=ds.spec.sketch), keys, r_upd,
                          weights=weights)
    return dataclasses.replace(
        ds, tables=_set_bucket(ds.tables, ds.cursor, s.table))


def _integer_pow(x: np.float32, n: int) -> np.float32:
    """x ** n for a Python int n >= 1 by binary exponentiation in float32
    multiplications -- the reference's `g ** b` (`lax.integer_pow`),
    which can differ from a float pow by an ulp -- each product flushed
    to zero below the smallest normal, as XLA's CPU does."""
    def mul(a, b):
        p = np.float32(a * b)
        return p if abs(p) >= np.float32(1.1754944e-38) else np.float32(0)

    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else mul(acc, x)
        n >>= 1
        if n > 0:
            x = mul(x, x)
    return np.float32(1.0) if acc is None else acc


def decayed_weights_host(cursor: int, buckets: int, gamma: float
                         ) -> np.ndarray:
    """(B+1,) float32 query weights of a decayed leaf: gamma^age of each
    ring bucket (`xla_f32.pow`, the reference's float32 `**`), then
    gamma^B for the tail (binary exponentiation, as the reference computes
    it)."""
    g = np.float32(gamma)
    ring = xla_f32.pow(g, (int(cursor) - np.arange(buckets)) % buckets)
    return np.concatenate([ring, [_integer_pow(g, buckets)]]).astype(
        np.float32)


def decayed_query(ds: DecayedSketch, keys, engine: str = "auto"
                  ) -> torch.Tensor:
    """Recency-weighted estimates: ONE window-query launch over the
    (B+1, d, w) leaf (the tail rides as bucket B+1 with weight gamma^B).
    The weights are computed on the host and uploaded without a
    synchronize.  float32 (N,)."""
    weights = staging.upload(ds.tables.device, decayed_weights_host(
        ds.cursor, ds.spec.buckets, ds.gamma))[0]
    return ops.window_query_tables(ds.tables, ds.spec.sketch, keys, weights,
                                   mode="sum", engine=engine)
