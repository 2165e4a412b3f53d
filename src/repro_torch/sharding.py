"""Logical-axis sharding rules, the parts the routed code needs.

Counterpart of `repro/sharding.py`.  Every parameter and activation
declares *logical* axes ("embed", "heads", "batch", ...).  A rules table
maps logical axes to mesh axes per architecture family; changing a
sharding strategy is a rules edit, not a model edit.

Defaults (single-pod mesh ("data", "model"), multi-pod adds "pod"):

  batch/tokens        -> ("pod", "data")   data parallel
  embed (weights)     -> "data"            ZeRO/FSDP-style param sharding
  heads/kv/mlp/experts-> "model"           tensor/expert parallel
  vocab/table_rows    -> "model"           output + embedding sharding
  act_embed           -> "model"           saved-activation sharding
  act_seq             -> "model"           sequence parallel (residual stream)
  kv_seq              -> "data"            long-context decode KV sharding

The port carries the rule tables, `spec_for` (logical axes -> mesh axes
per dimension) and the `use_rules` context that the routed MoE reads
(`transformer._moe_shardmap`).  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` (`launch/mesh.make_host_mesh`)
or a mapping {mesh axis name: size}.  `sharding_for` and `constrain`
(GSPMD placement) wait for the DTensor slice.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

Rules = dict  # logical axis name -> mesh axis | tuple of mesh axes | None

LM_RULES: Rules = {
    "batch": ("pod", "data"),
    "act_seq": "model",      # sequence-parallel residual stream
    "act_embed": None,
    "embed": "data",         # FSDP axis for weights
    "heads": "model",
    "kv_heads": "model",     # packed weight dim (n_kv * d_head)
    "mlp": "model",
    "expert_mlp": None,      # per-expert ff dim: EP only, no nested TP
    "experts": "model",
    "vocab": "model",
    "kv_seq": None,
    "cache_heads": None,     # head-count dim of the KV cache (often tiny)
    "layers": None,
}

# decode: the KV cache is the working set -- shard its sequence dim over the
# model axis (flash-decoding-style split-S); batch stays on data
LM_DECODE_RULES: Rules = dict(LM_RULES, act_seq=None, kv_seq="model")
# batch=1 long-context decode: nothing to data-shard except the KV sequence
LM_LONGCTX_RULES: Rules = dict(LM_RULES, batch=None, act_seq=None,
                               kv_seq=("pod", "data", "model"))

RECSYS_RULES: Rules = {
    "batch": ("pod", "data"),
    "table_rows": "model",
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "candidates": ("pod", "data"),
    "layers": None,
    "act_embed": None,
    "act_seq": None,
}

GNN_RULES: Rules = {
    # graphs parallelize over edges; d_hidden=128 is too small to split
    "edges": ("pod", "data", "model"),
    "nodes": None,
    "triplets": ("pod", "data", "model"),
    "batch": ("pod", "data"),
    "embed": None,
    "mlp": None,
    "layers": None,
}

_state = threading.local()


def mesh_shape(mesh) -> dict:
    """{mesh axis name: size} of a DeviceMesh or of such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(names)}


def spec_for(axes: Optional[tuple], rules: Rules, mesh,
             shape: Optional[tuple] = None) -> tuple:
    """Logical axes tuple -> one entry per dimension: a tuple of mesh axis
    names, or None (replicated); the reference's PartitionSpec entries.

    Drops mesh axes absent from `mesh`; with `shape` given, also drops mesh
    axes a dimension cannot divide evenly (longest divisible prefix), so
    e.g. a (256, 1) weight or a 50-dim head projection degrades gracefully
    to replication.
    """
    if axes is None:
        return ()
    sizes = mesh_shape(mesh)
    out = []
    for i, ax in enumerate(axes):
        target = rules.get(ax) if ax is not None else None
        if target is None:
            out.append(None)
            continue
        names = (target,) if isinstance(target, str) else tuple(target)
        names = tuple(n for n in names if n in sizes)
        if shape is not None:
            while names:
                factor = 1
                for n in names:
                    factor *= sizes[n]
                if shape[i] % factor == 0:
                    break
                names = names[:-1]
        out.append(names if names else None)
    return tuple(out)


@contextlib.contextmanager
def use_rules(rules: Rules, mesh):
    """Make (rules, mesh) visible to model code (`current_ctx`)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (rules, mesh)
    try:
        yield
    finally:
        _state.ctx = prev


def current_ctx():
    """(rules, mesh) made active by use_rules, or None."""
    return getattr(_state, "ctx", None)
