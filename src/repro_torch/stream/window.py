"""Time-scoped sketches: the sliding-window bucket ring (PyTorch).

Counterpart of `repro/stream/window.py` for what the windowed counting
service needs.  A `WindowedSketch` is a ring of B bucket tables of one
`SketchSpec`: the active bucket (the cursor) absorbs updates, and with
`WindowSpec.interval` set, event timestamps drive the ring forward
(watermarks), zeroing the buckets rotation reuses, so bucket b holds
exactly the events of one interval.  A window query over the last k
buckets combines the per-bucket estimates in ONE kernel launch
(`kernels.ops.window_query_tables`):

  * mode="sum" (default): each bucket's estimate (min over rows, decode)
    weighted and summed in bucket order -- the union-count estimator;
  * mode="max": the largest weighted bucket estimate;
  * gamma: lazy decay -- bucket b's estimate is weighted by gamma^age at
    query time, never in the stored counters.

In the port a `WindowedSketch` is a view: `CountService`'s window planes
keep every tenant's ring in one (T, B, d, w) leaf and hand out views of
it.  A tiered plane's cold tenants keep their rings in host memory and
rotate them with `cold_advance`.  `window_init` / `window_update` /
`window_rotate` / `window_advance_to`, `decay` and `DecayedSketch` are
later slices.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import staging
from repro_torch.core.counters import f32, signed_view
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
    or gamma^age with lazy decay (one evaluation for every ring)."""
    k = buckets if n_buckets is None else n_buckets
    if not 1 <= k <= buckets:
        raise ValueError(f"window of {k} buckets outside ring of {buckets}")
    cursors = np.asarray(cursors, np.int64).reshape(-1, 1)
    ages = torch.from_numpy((cursors - np.arange(buckets)[None, :])
                            % buckets)
    live = (ages < k).to(torch.float32)
    if gamma is not None:
        if not 0.0 < gamma <= 1.0:
            raise ValueError("gamma must be in (0, 1]")
        live = live * torch.pow(torch.tensor(f32(gamma)),
                                ages.to(torch.float32))
    return live.numpy()


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
