"""Walk the re-encoding path's float32 domains and count where the port's
replica math (`repro_torch/core/xla_f32.py`) differs from `jnp` on the
CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/xla_f32_check.py \
        [--stride 1] [--chunk 4194304]

The reference decodes a log cell as `expm1(s * log b) / (b - 1)`, weighs a
state step as `exp(s * log b)` and floors a value v as
`floor(log1p(v * (b - 1)) / log b)`, each op a float32 XLA computation.
For CMLS16 and CMLS8 this checks, bit for bit:

  * `expm1` and `exp` at `s * log b` for every state s (and `tanh` at
    half of it, which `expm1` takes below 0.5);
  * `log1p` at `v * (b - 1)` for every float32 v in [0, 2 * max_value]
    (every `--stride`-th one; 1, the default, walks all of them, about
    1.4e9 a format, in chunks of `--chunk`).  `merge(estimate_sum)` floors
    the sum of two decodes, up to 2 * max_value, and the decayed fold
    tail * gamma + oldest, up to (1 + gamma) * max_value with gamma <= 1.

The tool imports JAX (the reference); the port never does.  Host only:
about ten minutes on an 8-core CPU at the default stride.  Prints one
line a function and format, and one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core import xla_f32
from repro_torch.core.counters import CMLS8, CMLS16

jax.config.update("jax_platforms", "cpu")

FORMATS = {"CMLS16": CMLS16, "CMLS8": CMLS8}


def differ(name: str, x: np.ndarray) -> int:
    """Inputs where xla_f32.<name>(x) and jnp.<name>(x) differ in bits."""
    got = getattr(xla_f32, name)(torch.from_numpy(np.array(x))).numpy()
    want = np.asarray(getattr(jnp, name)(jnp.asarray(x)))
    return int((got.view(np.int32) != want.view(np.int32)).sum())


def check_states(counter) -> dict:
    states = jnp.arange(counter.max_state + 1, dtype=jnp.float32)
    arg = np.asarray(states * jnp.float32(math.log(counter.base)))
    return {"states": int(arg.size), "expm1": differ("expm1", arg),
            "exp": differ("exp", arg),
            "tanh": differ("tanh", np.asarray(jnp.asarray(arg) * 0.5))}


def check_log1p(counter, stride: int, chunk: int) -> dict:
    """Every stride-th float32 v in [0, 2 * max_value], through
    v * (b - 1)."""
    top = int(np.float32(2.0 * counter.max_value).view(np.int32))
    bm1 = jnp.float32(counter.base - 1.0)
    n = bad = 0
    for lo in range(0, top + 1, chunk * stride):
        bits = np.arange(lo, min(lo + chunk * stride, top + 1), stride,
                         dtype=np.int32)
        x = np.asarray(jnp.asarray(bits.view(np.float32)) * bm1)
        n += x.size
        bad += differ("log1p", x)
    return {"log1p_inputs": n, "log1p": bad}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=1 << 22)
    args = ap.parse_args(argv)
    out = {}
    for name, counter in FORMATS.items():
        t0 = time.time()
        res = check_states(counter)
        res.update(check_log1p(counter, args.stride, args.chunk))
        res["seconds"] = round(time.time() - t0, 1)
        out[name] = res
        print(f"{name}: expm1 {res['expm1']}, exp {res['exp']}, tanh "
              f"{res['tanh']} of {res['states']} states apart; log1p "
              f"{res['log1p']} of {res['log1p_inputs']} values apart "
              f"({res['seconds']} s)", flush=True)
    print(json.dumps({"stride": args.stride, "formats": out}))
    return out


if __name__ == "__main__":
    sys.exit(0 if all(v[k] == 0 for v in main().values()
                      for k in ("expm1", "exp", "tanh", "log1p")) else 1)
