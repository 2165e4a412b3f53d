"""Multi-device sketch helpers (PyTorch): so far only `tier_assemble`.

Counterpart of `repro/core/sharded.py`.  The collectives (`pmax_merge`
and the key-routed layouts on `torch.distributed`) are a later slice of
the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import staging
from repro_torch.core.counters import signed_view


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
