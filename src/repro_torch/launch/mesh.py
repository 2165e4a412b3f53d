"""Process-group construction for the sharded sketches
(`core/sharded.py`), the counterpart of `repro/launch/mesh.py`.

Nothing tells a process of a cluster, so the caller names the world size,
its rank and a rendezvous: a file every rank can reach (a `FileStore`,
`init_file`).  NCCL is the backend on the
GPU, gloo the CPU backend, each only when named or implied: a run that
asks for NCCL on a machine without CUDA raises instead of carrying on
under gloo.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist


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
