"""Gemma-2 27B (arXiv:2408.00118; hf), PyTorch.

Counterpart of `repro/configs/gemma2_27b.py`, field for field: 46L
d_model=4608 32H GQA(kv=16) d_ff=36864 (GeGLU) vocab=256000, alternating
local(4096)/global attention, attn softcap 50, final logit softcap 30,
pre+post RMSNorm with (1+w) scaling, sqrt(d) embed scale, query scale
(d_model/n_heads)^-0.5 = 144^-0.5, tied embeddings.
"""
import torch

from repro_torch.configs.registry import LM_SHAPES, Arch, register
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="gemma2-27b",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=36864, vocab_size=256_000,
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,
    post_norms=True, norm_unit_offset=True, embed_scale=True,
    tie_embeddings=True, activation="gelu",
)

SMOKE = LMConfig(
    name="gemma2-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=256, vocab_size=512,
    pattern=("local", "global"), window=8,
    attn_softcap=50.0, final_softcap=30.0, query_scale=16.0 ** -0.5,
    post_norms=True, norm_unit_offset=True, embed_scale=True,
    tie_embeddings=True, activation="gelu", dtype=torch.float32,
)

register(Arch(
    name="gemma2-27b", family="lm", cfg=CFG, smoke_cfg=SMOKE,
    shapes=LM_SHAPES,
    notes="local+global alternating, softcaps, post-norms",
))
