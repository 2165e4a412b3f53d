"""Checkpointing: atomic, keep-k, async (PyTorch).

Counterpart of `repro/train/checkpoint.py`, in the same on-disk format,
so either package restores what the other wrote.  One directory a step:

    <root>/step_00000123.tmp/        # written first
        manifest.json                # step, hosts, leaf shapes/dtypes, meta
        shard_00000.npz              # this host's leaves
    <root>/step_00000123/            # atomic rename once fully written

A tree is nested dicts and lists whose leaves are tensors or numpy
arrays.  A leaf is named by its path, parts joined by "/" (for example
`planes/0/topk/keys`), and leaves are listed as the reference's
`jax.tree_util` flattening lists them: dict keys sorted, list items in
order.  Tensors are written in their own dtype (uint16 and uint32 kept
unsigned).

`restore(root, target)` maps the saved leaves onto a target tree of the
same structure whose leaves are tensors, numpy arrays or `Leaf`
(shape, dtype) specs: a tensor, or a `Leaf` with a torch dtype, comes
back as a tensor on `device` (default: the target tensor's device, else
CUDA); a numpy array, or a `Leaf` with a numpy dtype, as a numpy array
on the host.  The saved dtype is kept.

Placed trees cross meshes as the reference's `device_put(arr,
like.sharding)` does: `save` writes each DTensor leaf whole
(`full_tensor()`, a gather every rank of its mesh joins; rank 0 writes
the one file, the others wait at a barrier, in `save` and in the
`join()` of `save_async`'s `Pending`), and a DTensor target leaf
comes back with the target's mesh and placements, each rank keeping its
shard (`sharding.distribute`), whatever mesh wrote it.  So a JAX-written
checkpoint, or numpy parameters, go onto a mesh through `place`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.counters import from_numpy, to_numpy
from repro_torch.sharding import is_dtensor, distribute


@dataclasses.dataclass(frozen=True)
class Leaf:
    """Shape and dtype of a restore-target leaf that needs no buffer."""
    shape: tuple
    dtype: Any


def _walk(tree, fn, path: str = ""):
    """`tree` with each leaf replaced by fn(path, leaf), in flattening
    order (dict keys sorted, list items in order); None is an empty
    subtree, as in jax."""
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, f"{path}{k}/") for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}{i}/")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path[:-1], tree)


def flatten(tree) -> dict[str, Any]:
    """{leaf path: leaf} in flattening order."""
    flat: dict[str, Any] = {}
    _walk(tree, flat.__setitem__)
    return flat


def _host(leaf) -> np.ndarray:
    """A host copy of the leaf, never a view of live state (a CPU tensor's
    `.numpy()` shares its memory, and the service updates in place); a
    DTensor whole."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        host = to_numpy(leaf)
        return host.copy() if leaf.device.type == "cpu" else host
    return np.array(leaf, copy=True)


def save(root: str, step: int, tree, metadata: Optional[dict] = None,
         host_id: int = 0, keep_last: int = 3) -> str:
    """Atomic checkpoint write; returns the final directory."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    flat = flatten(tree)
    arrays = {k: _host(v) for k, v in flat.items()}
    placed = any(is_dtensor(v) for v in flat.values())
    if placed and torch.distributed.get_rank() != 0:
        torch.distributed.barrier()  # rank 0 writes the one file
        return final
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **arrays)
    manifest = {
        "step": step,
        "hosts": [host_id],
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(root, keep_last)
    if placed:
        torch.distributed.barrier()
    return final


def to_host(tree):
    """The tree with every leaf a numpy array (tensors copied to the
    host in their storage dtype)."""
    return _walk(tree, lambda _, leaf: _host(leaf))


class Pending:
    """A checkpoint being written (`save_async`): `join()` returns once it
    is published.  A placed tree is published by rank 0 alone, and every
    rank's `join()` ends at a barrier, so no rank reads it before then."""

    def __init__(self, thread: Optional[threading.Thread], placed: bool):
        self.thread, self.placed = thread, placed

    def join(self, timeout: Optional[float] = None) -> None:
        if self.thread is not None:
            self.thread.join(timeout)
        if self.placed:
            torch.distributed.barrier()

    def is_alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


def save_async(root: str, step: int, tree, **kw) -> Pending:
    """Copy the tree to host memory now (DTensor leaves whole: a gather
    every rank of their mesh joins), write it in a background thread;
    join the returned `Pending` before reading the checkpoint.  A placed
    tree is written by rank 0 only; every rank must join."""
    placed = any(is_dtensor(v) for v in flatten(tree).values())
    snapshot = to_host(tree)
    if placed and torch.distributed.get_rank() != 0:
        return Pending(None, placed)
    t = threading.Thread(target=save, args=(root, step, snapshot), kwargs=kw,
                         daemon=True)
    t.start()
    return Pending(t, placed)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _resolve_step(root: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    return step


def load_metadata(root: str, step: Optional[int] = None):
    """(metadata, step) of a checkpoint without loading any leaves (the
    service reads its plane layout here to build the restore target)."""
    step = _resolve_step(root, step)
    with open(os.path.join(root, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)["metadata"], step


def restore(root: str, target, step: Optional[int] = None, device=None):
    """(tree, manifest): the saved leaves on `target`'s structure (see the
    module docstring).  A leaf the checkpoint lacks raises KeyError; a
    shape that differs from the target's raises ValueError naming it."""
    step = _resolve_step(root, step)
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data: dict[str, np.ndarray] = {}
    for h in manifest["hosts"]:
        with np.load(os.path.join(d, f"shard_{h:05d}.npz")) as z:
            data.update({k: z[k] for k in z.files})
    return place(data, target, device), manifest


def place(data: dict, target, device=None):
    """`target`'s structure with each leaf taken from the flat {path:
    array} `data` (see the module docstring): a tensor target comes back
    as a tensor on `device` (default: its own device), a numpy target as
    numpy."""
    dev = None if device is None else torch.device(device)

    def load(key: str, like):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.asarray(data[key])
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"checkpoint leaf {key} has shape {tuple(arr.shape)} but "
                f"the restore target expects {tuple(like.shape)}; build "
                f"the target with the writer's geometry and reshape after "
                f"restoring")
        if is_dtensor(like):
            full = from_numpy(arr, dev or like.to_local().device)
            return distribute(full, like.device_mesh, like.placements)
        if isinstance(like, torch.Tensor):
            return from_numpy(arr, dev or like.device)
        if isinstance(like, Leaf) and isinstance(like.dtype, torch.dtype):
            return from_numpy(arr, dev or torch.device("cuda"))
        return arr

    return _walk(target, load)


def _gc(root: str, keep_last: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(root)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)
