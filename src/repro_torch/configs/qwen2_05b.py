"""Qwen2-0.5B (arXiv:2407.10671; hf), PyTorch.

Counterpart of `repro/configs/qwen2_05b.py`, field for field: 24L
d_model=896 14H GQA(kv=2) d_ff=4864 vocab=151936, QKV bias, tied
embeddings.  Pure full attention: long_500k skipped (assignment rule).
"""
import torch

from repro_torch.configs.registry import LM_SHAPES, Arch, register
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="qwen2-0.5b",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151_936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
    pattern=("global",) * 2,
)

SMOKE = LMConfig(
    name="qwen2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=512, qkv_bias=True, tie_embeddings=True,
    dtype=torch.float32,
)

register(Arch(
    name="qwen2-0.5b", family="lm", cfg=CFG, smoke_cfg=SMOKE,
    shapes=LM_SHAPES, skip_shapes=("long_500k",),
    notes="pure full attention -> long_500k skipped (assignment rule)",
))
