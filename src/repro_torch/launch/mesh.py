"""Process-group and mesh construction, the counterpart of
`repro/launch/mesh.py`: the group the sharded sketches
(`core/sharded.py`) run on, and the 2-D ("data", "model") host mesh of
the routed model code (`make_host_mesh`).

Nothing tells a process of a cluster, so the caller names the world size,
its rank and a rendezvous: a file every rank can reach (a `FileStore`,
`init_file`).  NCCL is the backend on the
GPU, gloo the CPU backend, each only when named or implied: a run that
asks for NCCL on a machine without CUDA raises instead of carrying on
under gloo.  `make_production_mesh` (the TPU pod's 16 x 16 layout) has
no counterpart yet.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def init_group(world_size: int = 1, rank: int = 0, backend: str | None = None,
               init_file: str | None = None):
    """Initialize the default process group and return it.

    backend: "nccl" (the default: the GPU, each rank on card
    rank % device_count) or "gloo" (the CPU).  The rendezvous is the
    file `init_file` (a `FileStore` every rank can reach); a one-rank
    group without one gets a fresh file under the temporary directory."""
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs CUDA; pass "
                               "backend='gloo' to run on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if init_file is None:
        if world_size != 1:
            raise ValueError("a group of several ranks needs a shared "
                             "init_file")
        fd, init_file = tempfile.mkstemp(prefix="cml_group_")
        os.close(fd)
        os.unlink(init_file)
    dist.init_process_group(backend,
                            init_method=f"file://{os.path.abspath(init_file)}",
                            world_size=world_size, rank=rank)
    return dist.group.WORLD


def make_host_mesh(model: int = 1):
    """A ("data", "model") `DeviceMesh` of shape (world // model, model)
    over the initialized default group (rank r at data r // model, model
    r % model), on CUDA under NCCL and on the CPU under gloo.  Its axis
    groups are `mesh.get_group("data")` and `mesh.get_group("model")`."""
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"size {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=("data", "model"))
