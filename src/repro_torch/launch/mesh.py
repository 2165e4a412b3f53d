"""Process-group and mesh construction, the counterpart of
`repro/launch/mesh.py`: the group the sharded sketches
(`core/sharded.py`) run on, the 2-D ("data", "model") host mesh of
the placed and routed model code (`make_host_mesh`), and the production
meshes of the dry run (`make_production_mesh`).

Nothing tells a process of a cluster, so the caller names the world size,
its rank and a rendezvous: a file every rank can reach (a `FileStore`,
`init_file`).  NCCL is the backend on the
GPU, gloo the CPU backend, each only when named or implied: a run that
asks for NCCL on a machine without CUDA raises instead of carrying on
under gloo.  `init_fake_group` starts the "fake" backend of
`torch.testing`, whose collectives move nothing: one process stands for
rank 0 of a 256- or 512-rank job (the dry run).
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


def init_fake_group(world_size: int) -> None:
    """A "fake" default group of `world_size` ranks seen from rank 0: its
    collectives complete at once and move nothing (shapes only)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes over the initialized group, real
    or fake: (16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") for two pods.  The shapes are the TPU pods' (256 chips a
    pod), kept so that per-device shapes compare cell for cell with the
    reference's dry run; on H100s that is 32 or 64 hosts of 8 cards,
    rank r on host r // 8, so a "model" group of 16 consecutive ranks
    spans two hosts.  Raises unless the world size is 256 or 512 to
    match."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size()
    if world != 256 * (2 if multi_pod else 1):
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} "
                         f"mesh {shape} needs {256 * (2 if multi_pod else 1)}"
                         f" ranks, the group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def host_mesh_on(device: torch.device, model: int = 1):
    """`make_host_mesh(model)` over the initialized group, or over a
    one-rank group on `device`'s backend (NCCL for CUDA, gloo for the
    CPU) started when none is."""
    if not dist.is_initialized():
        init_group(1, 0, backend="nccl" if device.type == "cuda" else "gloo")
    return make_host_mesh(model)


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
