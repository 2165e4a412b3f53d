"""What the tiered cold store's growing buffer saves when a service
registers its tenants.

    python3 tools/tier_grow.py [--reps 3]

A tiered plane keeps its cold store on the host, one table row per
tenant (`repro_torch/stream/tiering.py` `PlaneTier`).  The port grows it
by doubling a buffer it is a view of (`PlaneTier._grow_cold`), so that
registering T tenants copies O(T) rows; the JAX package concatenates a
zero row onto the whole store for every tenant, O(T^2) rows.  This times
`add_row` for every tenant of `chip_smoke.py`'s two tiered services, at
their full size, with the port's growth and with the concatenation, in
interleaved pairs:

  * tracked: 64 tenants of (2, 1,048,576) uint16 CMLS16 tables (4 MiB a
    tenant), ring 65,536;
  * windowed: 32 tenants of (8, 2, 1,048,576) uint16 rings (32 MiB a
    tenant), ring 65,536.

Host time only (numpy on the host; no device work).  Prints the card's
name and power limit when `nvidia-smi` is there, and one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = {"tracked": (64, (2, 1 << 20)),
         "windowed": (32, (8, 2, 1 << 20))}
RING = 65_536


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError:
        return "no nvidia-smi"
    return (out.stdout.strip().splitlines() or ["no card"])[0]


def register_seconds(tier_cls, tenants: int, row_shape: tuple) -> float:
    from repro_torch.stream.tiering import PlaneTier, TierSpec
    assert issubclass(tier_cls, PlaneTier)
    t0 = time.perf_counter()
    tier = tier_cls(TierSpec(max_hot_tenants=8), row_shape, np.uint16, RING)
    for _ in range(tenants):
        tier.add_row()
    seconds = time.perf_counter() - t0
    assert tier.cold.shape == (tenants,) + row_shape and not tier.cold.any()
    return seconds


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.stream.tiering import PlaneTier

    class ConcatTier(PlaneTier):
        """The JAX package's growth: one concatenation per tenant."""

        def _grow_cold(self) -> None:
            self.cold = np.concatenate(
                [self.cold, np.zeros((1,) + self.row_shape, self.dtype)])

    print(f"card: {card()}", flush=True)
    out = {}
    for name, (tenants, row_shape) in CASES.items():
        grow, concat = [], []
        for _ in range(args.reps):
            grow.append(register_seconds(PlaneTier, tenants, row_shape))
            concat.append(register_seconds(ConcatTier, tenants, row_shape))
        out[name] = {"tenants": tenants, "row_bytes": 2 * int(
            np.prod(row_shape)), "seconds_doubling": grow,
            "seconds_concatenate": concat,
            "median_saving_s": float(np.median(concat) - np.median(grow))}
        print(f"{name}: {tenants} tenants x {out[name]['row_bytes']} B, "
              f"add_row for all: doubling {grow} s, concatenate {concat} s",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
