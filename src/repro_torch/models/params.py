"""Minimal parameter-definition layer (specs -> tensors), PyTorch.

Counterpart of `repro/models/params.py`.  Models declare parameters as
nested dicts of `P(shape, axes, init)`; `init_tree` makes float32
tensors on the caller's device (CUDA unless asked for the CPU) with the
reference's init rules.  The draws come from a `torch.Generator`, so
they are not the reference's `jax.random.normal` bits: tests carry
weights across with `convert.params_from_numpy` instead.

A tree here is nested dicts with string keys; `flatten` (the
checkpoints' own) lists its leaves as `jax.tree_util` flattens the
reference's (keys sorted), under paths joined by "/" (`tables/t0`,
`bot/w0`), the paths the optimizer's label function reads.

`abstract_tree` makes tensors that allocate nothing: inside a
`FakeTensorMode` fake ones on the mesh's device type, else on the
"meta" device; with a mesh each is a DTensor carrying
`sharding.sharding_for`'s placements (its local shard is rank's share).
`tree_shardings` is the tree of those placements, which
`train/checkpoint.place` and `distribute_tree` put concrete leaves on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.sharding import (Rules, chunk_range, distribute, from_local,
                                  sharding_for)
from repro_torch.train.checkpoint import flatten


@dataclasses.dataclass(frozen=True)
class P:
    shape: tuple
    axes: Optional[tuple] = None   # logical axis per dim (None entries ok)
    init: str = "lecun"            # lecun | normal:<std> | zeros | ones | embed
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} rank != shape {self.shape}")


def unflatten(flat: dict[str, Any]) -> dict:
    """The nested dict whose `flatten` is `flat`."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def tree_map(fn, tree):
    """`tree` with every leaf replaced by fn(leaf)."""
    return unflatten({k: fn(v) for k, v in flatten(tree).items()})


def _init_one(spec: P, gen: torch.Generator, dev: torch.device
              ) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init.startswith("normal:"):
        std = float(spec.init.split(":")[1])
    elif spec.init == "embed":
        std = None
    else:  # lecun: fan-in = product of all dims but the last
        std = 1.0 / math.sqrt(max(1, math.prod(spec.shape[:-1])))
    x = torch.randn(spec.shape, generator=gen, dtype=spec.dtype, device=dev)
    return x if std is None else x.mul_(std)


def init_tree(specs, generator=None, device=None) -> dict:
    """Tensors for a spec tree, drawn leaf by leaf in flattening order.

    `generator`: a `torch.Generator` on the device, or an int seed (None
    is seed 0).  `device`: CUDA unless "cpu" is asked for."""
    dev = resolve_device(device)
    if generator is None or isinstance(generator, int):
        seed = generator or 0
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return tree_map(lambda s: _init_one(s, generator, dev), specs)


def _local_shape(shape, mesh, placements) -> tuple:
    """This rank's shard shape (torch.chunk's split, as DTensor's)."""
    return tuple(chunk_range(n, mesh, [d for d, p in enumerate(placements)
                                       if p.is_shard(i)])[1]
                 for i, n in enumerate(shape))


def abstract_tree(specs, rules: Rules = None, mesh=None):
    """Tensors with each spec's shape and dtype that allocate nothing:
    fake ones inside an active `FakeTensorMode`, meta ones otherwise;
    DTensors with `sharding_for`'s placements when a mesh is given."""
    from torch._guards import detect_fake_mode

    fake = detect_fake_mode() is not None

    def mk(s: P):
        if mesh is None:
            return torch.empty(s.shape, dtype=s.dtype,
                               device="cpu" if fake else "meta")
        pl = sharding_for(s.axes, rules, mesh, s.shape)
        local = torch.empty(_local_shape(s.shape, mesh, pl), dtype=s.dtype,
                            device=mesh.device_type if fake else "meta")
        return from_local(local, mesh, pl, s.shape)

    return mk(specs) if isinstance(specs, P) else tree_map(mk, specs)


def tree_shardings(specs, rules: Rules, mesh) -> dict:
    """The tree of each spec's DTensor placements on `mesh` (a tuple a
    leaf: read it by path, `flatten` would walk into it)."""
    return unflatten({k: sharding_for(s.axes, rules, mesh, s.shape)
                      for k, s in flatten(specs).items()})


def _at_path(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def distribute_tree(tree, shardings, mesh) -> dict:
    """Each leaf of `tree` (the same leaf on every rank) as a DTensor with
    its placements from `shardings` (`sharding.distribute`: each rank
    keeps its own shard; no data moves between ranks)."""
    return unflatten({k: distribute(v, mesh, _at_path(shardings, k))
                      for k, v in flatten(tree).items()})


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in flatten(specs).values())


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype)
               .element_size() for s in flatten(specs).values())
