"""Quickstart (PyTorch port): count a stream with CMS-CU vs Count-Min-Log,
query, compare.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The same stream, sketches and draws as `examples/quickstart.py` (the raw
key (0, s) is the reference's `PRNGKey(s)`), so the same numbers.  Runs
on the GPU unless `--device cpu`; `ops.update` / `ops.query` are the
hand-written CUDA kernels there (the fused update and the fused query).
"""
import argparse

import numpy as np

from repro_torch.core import (CMLS8, CMLS16, CMS32, SketchSpec, init, query,
                              update)
from repro_torch.core.counters import from_numpy
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops

BUDGET = 64 * 1024  # bytes: well under the ~120 kB a perfect map needs
FORMATS = [("CMS-CU (32-bit linear)", CMS32),
           ("CMLS16-CU (b=1.00025)", CMLS16),
           ("CMLS8-CU  (b=1.08)", CMLS8)]


def raw_key(seed: int) -> np.ndarray:
    """The raw threefry key the reference's `jax.random.PRNGKey(seed)` is."""
    return np.array([0, seed], np.uint32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--events", type=int, default=200_000)
    ap.add_argument("--kernel-events", type=int, default=50_000)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a skewed event stream (Zipf, like word frequencies)
    rng = np.random.default_rng(0)
    events_np = (rng.zipf(1.3, args.events) % 30_000).astype(np.uint32)
    uniq, true = np.unique(events_np, return_counts=True)
    events = from_numpy(events_np, dev)
    probes = from_numpy(uniq, dev)
    print(f"stream: {events.shape[0]} events, {len(uniq)} distinct keys, "
          f"{BUDGET // 1024} kB sketch budget\n")

    are = {}
    for name, counter in FORMATS:
        spec = SketchSpec.from_memory(BUDGET, depth=2, counter=counter)
        sketch = update(init(spec, device=dev), events, raw_key(0),
                        mode="batched")
        est = query(sketch, probes).cpu().numpy()
        are[name] = float(np.mean(np.abs(est - true) / true))
        print(f"{name:24s} width={spec.width:7d}  ARE={are[name]:8.4f}")

    # the kernel path: the same semantics, one fused launch each
    spec = SketchSpec.from_memory(BUDGET, depth=2, counter=CMLS16)
    sketch = ops.update(init(spec, device=dev),
                        events[:args.kernel_events], raw_key(1))
    est = ops.query(sketch, probes[:8]).cpu().numpy()
    kernel_est = [round(float(x), 1) for x in est]
    print("\nkernel estimates (first 8 keys):", kernel_est)
    print("true counts                    :", true[:8].tolist())
    return {"are": are, "kernel_estimates": kernel_est,
            "true": true[:8].tolist()}


if __name__ == "__main__":
    main()
