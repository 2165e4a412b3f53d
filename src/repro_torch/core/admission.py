"""Count-based embedding admission, gated by a sketch (PyTorch).

Counterpart of `repro/core/admission.py`.  An embedding table cannot
afford a row per raw id, so an id earns a private row only once it is
hot enough; cold ids share a small fallback space (hash trick), so every
id maps to some row.  Two decision sources share one row policy
(`rows_of`):

  * `admit` / `observe_and_admit` threshold the sketch estimate itself.
    `observe_and_admit` counts the batch first, through the CUDA kernels
    (`engine="kernel"`: `ops.update_chunked`, then `ops.query`) or the
    chunk-sequential plain engine (`engine="xla"`: `ops.update_xla`, then
    the plain query); the two are bit-identical at every table size, and
    `"auto"` takes the kernels for every CUDA table.
  * `admit_tracked` decides from a heavy-hitter tracker heap: an id is
    admitted iff it is a filled candidate whose stored estimate clears
    the threshold.  This is the service's tracker-fed admission plane
    (`CountService.add_tenant(admission=...)`): an (N, K) compare on the
    device, no sketch launch and no host copy.

Ids are validated like `CountService.enqueue`'s keys: floats raise
TypeError, negatives and values past 32 bits ValueError.  A torch.uint32
tensor is taken as it is (every uint32 is a valid key), and host ids go
up through `core/staging.py`, so a decision issues no synchronize.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sketch as sk
from repro_torch.core.counters import signed_view
from repro_torch.core.hashing import as_i64, mix32
from repro_torch.kernels import ops

ENGINES = ("auto", "kernel", "xla")


@dataclasses.dataclass(frozen=True)
class AdmissionSpec:
    threshold: float = 8.0      # min estimated count before a private row
    n_fallback: int = 1024      # shared rows for cold ids
    table_rows: int = 1 << 20   # private rows (admitted ids hash here)


def _validated(ids, device) -> torch.Tensor:
    """Ids as torch.uint32 on `device`: a uint32 tensor passes through
    (moved only if it lies elsewhere); anything else is checked on the
    host and uploaded without a synchronize."""
    if isinstance(ids, torch.Tensor):
        if ids.dtype == torch.uint32:
            return ops.as_device_keys(ids, device)
        shape = tuple(ids.shape)
    else:
        shape = np.shape(ids)
    return ops.read_keys(sk.as_uint32_keys(ids).reshape(shape), device)


def rows_of(ids: torch.Tensor, admitted: torch.Tensor, spec: AdmissionSpec
            ) -> torch.Tensor:
    """Map ids -> embedding rows given their admission mask (int32).

    Admitted ids occupy [n_fallback, n_fallback + table_rows); cold ids
    share [0, n_fallback).  The row policy is independent of how the mask
    was decided."""
    k = as_i64(ids)
    hot = (mix32(k) % spec.table_rows).to(torch.int32) + spec.n_fallback
    cold = (mix32(k ^ 0xC01D) % spec.n_fallback).to(torch.int32)
    return torch.where(admitted, hot, cold)


def admit(sketch: sk.Sketch, ids, spec: AdmissionSpec
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, admitted mask) of ids against the sketch's own estimates."""
    ids = _validated(ids, sketch.table.device)
    admitted = sk.query(sketch, ids) >= spec.threshold
    return rows_of(ids, admitted, spec), admitted


def admit_tracked(keys: torch.Tensor, estimates: torch.Tensor,
                  filled: torch.Tensor, ids, spec: AdmissionSpec
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Admission decisions from one tenant's (K,) tracker row: an id is
    admitted iff it matches a filled candidate whose stored estimate is
    >= spec.threshold.  O(N * K) compares on the device; (rows, admitted
    mask) aligned with the 1D ids."""
    ids = _validated(ids, keys.device)
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1D, got shape {tuple(ids.shape)}")
    hot = filled & (estimates >= spec.threshold)
    eq = signed_view(ids)[:, None] == signed_view(keys)[None, :]
    admitted = (eq & hot[None, :]).any(dim=1)
    return rows_of(ids, admitted, spec), admitted


def observe_and_admit(sketch: sk.Sketch, ids, rng, spec: AdmissionSpec,
                      engine: str = "auto"
                      ) -> tuple[sk.Sketch, torch.Tensor, torch.Tensor]:
    """Count this batch, then admit against the new state: (sketch, rows,
    admitted).  `rng` is the raw threefry key of the update's uniforms.

    engine "kernel" runs the CUDA kernels (`ops.update_chunked`, then
    `ops.query`) at every table size, and raises for a CPU table; "xla"
    is the chunk-sequential plain engine on every device.  The two
    compute the same CHUNK-sequential update, so "auto" takes the
    kernels for every CUDA table: the reference's size switch stands for
    its VMEM budget, which the card does not have.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown admission engine {engine!r}")
    dev = sketch.table.device
    ids = _validated(ids, dev)
    if engine == "auto":
        engine = "kernel" if dev.type == "cuda" else "xla"
    elif engine == "kernel" and dev.type != "cuda":
        raise ValueError("engine='kernel' needs a CUDA table; use "
                         "engine='xla'")
    if engine == "kernel":
        sketch = ops.update_chunked(sketch, ids, rng)
        est = ops.query(sketch, ids)
    else:
        sketch = ops.update_xla(sketch, ids, rng)
        est = sk.query(sketch, ids)
    admitted = est >= spec.threshold
    return sketch, rows_of(ids, admitted, spec), admitted
