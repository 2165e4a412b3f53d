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
`bot/w0`), the paths the optimizer's label function reads.  `abstract_tree` and
`tree_shardings` wait for the sharding slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.device import resolve_device
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


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in flatten(specs).values())


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype)
               .element_size() for s in flatten(specs).values())
