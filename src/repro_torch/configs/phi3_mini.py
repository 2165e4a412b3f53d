"""Phi-3-mini 3.8B (arXiv:2404.14219; unverified), PyTorch.

Counterpart of `repro/configs/phi3_mini.py`, field for field: 32L
d_model=3072 32H MHA(kv=32) d_ff=8192 vocab=32064, RoPE + SwiGLU.  Pure
full attention: long_500k is skipped per the assignment rule.
"""
import torch

from repro_torch.configs.registry import LM_SHAPES, Arch, register
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="phi3-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab_size=32_064,
    pattern=("global",) * 2,
)

SMOKE = LMConfig(
    name="phi3-mini-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=512, dtype=torch.float32,
)

register(Arch(
    name="phi3-mini-3.8b", family="lm", cfg=CFG, smoke_cfg=SMOKE,
    shapes=LM_SHAPES, skip_shapes=("long_500k",),
    notes="pure full attention -> long_500k skipped (assignment rule)",
))
