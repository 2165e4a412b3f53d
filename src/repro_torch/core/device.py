"""Where the port's entry points run: CUDA unless the caller asks for the
CPU.  `resolve_device(None)` is CUDA, and a CUDA device without a GPU
raises instead of carrying on on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """None means CUDA.  A CUDA device without a GPU raises: entry points
    never carry on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
