"""Carry a counting service's state between the two packages in memory.

The layout is the checkpoint's (`CountService._meta()` / `_tree()`, the
reference's `repro/stream/service.py` layout, manifest v8): a JSON-able
metadata dict and a leaf tree of arrays, with the admission policies in
the metadata.  `service_from_numpy(meta, tree, device)` builds a port
service from the reference's metadata and numpy leaves;
`service_to_numpy(svc)` gives the same layout back, numpy leaves in their
storage dtypes, so two services compare leaf by leaf, byte for byte.  A
tiered service's state rides both ways: the TierSpec and each plane's
membership in the metadata, the cold stores (`cold_tables`) and the
tenant-indexed queue and fill mirrors among the leaves.

The standalone structures ride the same way, as the reference's pytree
leaves in numpy: a `Sketch` as its storage table, a `WindowedSketch` as
{"tables", "cursor", "epoch"} and a `DecayedSketch` as {"tables",
"cursor"} (its gamma and geometry are given beside them).  A structure
the JAX package built then goes on in the port, and back, with the same
answers.

Model weights and training state ride as nested dicts of numpy arrays:
`params_from_numpy(tree, device)` / `params_to_numpy(params)` for a
parameter (or optimizer-state) tree, and `train_state_from_numpy` /
`train_state_to_numpy` for a whole `TrainState` as {"params",
"opt_state", "step", "rng", "extras"} (mu / nu / acc under opt_state,
the int32 step and the raw (2,) uint32 key).  The JAX model and the
port's then start from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.counters import from_numpy, to_numpy
from repro_torch.core.device import resolve_device
from repro_torch.core.sketch import Sketch, SketchSpec
from repro_torch.models.params import tree_map
from repro_torch.stream import window as w
from repro_torch.stream.service import CountService
from repro_torch.train import checkpoint
from repro_torch.train.loop import TrainState


def service_from_numpy(meta: dict, tree: dict, device=None,
                       engine: str = "auto") -> CountService:
    """A port `CountService` holding the state `meta` + `tree` describe."""
    svc = CountService._from_meta(meta, None, device, engine)
    target = svc._tree(with_topk=meta.get("track_top") is not None)
    svc._load_tree(meta, checkpoint.place(checkpoint.flatten(tree), target))
    return svc


def service_to_numpy(svc: CountService) -> tuple[dict, dict]:
    """(meta, tree) of a port service in the reference's layout."""
    return svc._meta(), checkpoint.to_host(svc._tree())


def _table(a, spec: SketchSpec, lead: tuple, device) -> torch.Tensor:
    a = np.asarray(a)
    want = lead + (spec.depth, spec.storage_width)
    if a.shape != want:
        raise ValueError(f"table shape {a.shape} != {want}")
    t = from_numpy(a, resolve_device(device))
    if t.dtype != spec.storage_dtype:
        raise ValueError(f"table dtype {a.dtype} is not the storage dtype "
                         f"{spec.storage_dtype}")
    return t


def sketch_from_numpy(table, spec: SketchSpec, device=None) -> Sketch:
    """A port `Sketch` holding the (d, sw) storage table `table`."""
    return Sketch(table=_table(table, spec, (), device), spec=spec)


def sketch_to_numpy(sketch: Sketch) -> np.ndarray:
    """The storage table of a port `Sketch` as numpy (its storage dtype)."""
    return to_numpy(sketch.table)


def _opt_int(x):
    return None if x is None else int(np.asarray(x))


def window_from_numpy(leaves: dict, spec: w.WindowSpec, device=None
                      ) -> w.WindowedSketch:
    """A port `WindowedSketch` from {"tables" (B, d, sw), "cursor",
    "epoch" (None before the first watermark)}."""
    return w.WindowedSketch(
        tables=_table(leaves["tables"], spec.sketch, (spec.buckets,), device),
        cursor=int(np.asarray(leaves["cursor"])), spec=spec,
        epoch=_opt_int(leaves.get("epoch")))


def window_to_numpy(win: w.WindowedSketch) -> dict:
    """{"tables", "cursor", "epoch"} of a port `WindowedSketch`."""
    return {"tables": to_numpy(win.tables), "cursor": int(win.cursor),
            "epoch": _opt_int(win.epoch)}


def decayed_from_numpy(leaves: dict, spec: SketchSpec, gamma: float,
                       device=None) -> w.DecayedSketch:
    """A port `DecayedSketch` from {"tables" (B+1, d, sw), "cursor"}; the
    ring depth B is the leaf's first axis less one."""
    buckets = np.asarray(leaves["tables"]).shape[0] - 1
    return w.DecayedSketch(
        tables=_table(leaves["tables"], spec, (buckets + 1,), device),
        cursor=int(np.asarray(leaves["cursor"])),
        spec=w.WindowSpec(sketch=spec, buckets=buckets), gamma=gamma)


def decayed_to_numpy(ds: w.DecayedSketch) -> dict:
    """{"tables", "cursor"} of a port `DecayedSketch`."""
    return {"tables": to_numpy(ds.tables), "cursor": int(ds.cursor)}


def params_from_numpy(tree, device=None) -> dict:
    """A nested dict of arrays as tensors (one copy each) on `device`."""
    dev = resolve_device(device)
    return tree_map(lambda a: from_numpy(np.asarray(a), dev), tree)


def params_to_numpy(params) -> dict:
    """A nested dict of tensors as host numpy copies."""
    return checkpoint.to_host(params)


def train_state_from_numpy(tree: dict, device=None) -> TrainState:
    """A port `TrainState` from {"params", "opt_state", "step", "rng"[,
    "extras"]} of arrays (the reference state's leaves in numpy)."""
    extras = tree.get("extras")
    return TrainState(
        params=params_from_numpy(tree["params"], device),
        opt_state=params_from_numpy(tree["opt_state"], device),
        step=torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32),
        rng=np.asarray(tree["rng"], np.uint32).reshape(2),
        extras=None if extras is None else params_from_numpy(extras, device))


def train_state_to_numpy(state: TrainState) -> dict:
    """{"params", "opt_state", "step", "rng", "extras"} in numpy."""
    return {"params": params_to_numpy(state.params),
            "opt_state": params_to_numpy(state.opt_state),
            "step": np.asarray(int(state.step), np.int32),
            "rng": np.asarray(state.rng, np.uint32).copy(),
            "extras": (None if state.extras is None
                       else params_to_numpy(state.extras))}
