"""Gradient compression for the data-parallel all-reduce, PyTorch.

Counterpart of `repro/train/compression.py`: int8 quantization with
per-block scales and error feedback (EF14/EF21 family).  Each worker
quantizes (grad + residual), the fleet exchanges int8, and the
quantization error is carried to the next step: unbiased in the long
run, 4x fewer bytes on the wire.

Two forms:
  * `quantize` / `dequantize` + `compress_with_feedback`: numerics only;
  * `compressed_allreduce_mean`: the collective that moves int8 on the
    wire (an all-gather of int8 blocks and float32 scales over a
    `torch.distributed` group, then a local float32 mean).

The float32 expressions are the reference's, operation for operation;
`torch.round` rounds half to even as `jnp.round` does, so the int8
blocks and scales are the reference's bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.routing import all_gather

BLOCK = 2048


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    return F.pad(x.reshape(-1), (0, (-n) % BLOCK)), n


def quantize(g: torch.Tensor):
    """float -> (int8 values (blocks, BLOCK), per-block float32 scales
    (blocks, 1), element count)."""
    flat, n = _pad_to_block(g.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale, n


def dequantize(q, scale, n, shape):
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compress_with_feedback(g, residual):
    """(grad, residual) -> (quantized-dequantized grad, new residual)."""
    x = g.float() + residual
    q, scale, n = quantize(x)
    deq = dequantize(q, scale, n, g.shape)
    return deq, x - deq


def compressed_allreduce_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks of `group` (called by every rank) moving int8
    (+ float32 scales) on the wire.

    Wire bytes per element: 1 (int8) + 4/BLOCK (scales), against 4 for a
    float32 ring all-reduce: about a 4x cut of collective bytes.
    """
    q, scale, n = quantize(g)
    q_all = all_gather(q, group)            # (W, blocks, BLOCK) int8
    s_all = all_gather(scale, group)        # (W, blocks, 1) float32
    mean = torch.mean(q_all.float() * s_all, dim=0)
    return mean.reshape(-1)[:n].reshape(g.shape)
