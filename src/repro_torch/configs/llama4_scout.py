"""Llama-4 Scout 17B-active/16E (hf:meta-llama/Llama-4-Scout-17B-16E;
unverified), PyTorch.

Counterpart of `repro/configs/llama4_scout.py`, field for field: 48L
d_model=5120 40H GQA(kv=8) vocab=202048, MoE 16 routed top-1 + 1 shared
expert (d_ff=8192 each), iRoPE: chunked-local attention (8192) with
every 4th layer global and NoPE on global layers.
"""
import torch

from repro_torch.configs.registry import LM_SHAPES, Arch, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=202_048,
    pattern=("chunked", "chunked", "chunked", "global"),
    attn_chunk=8192, rope_on_global=False, rope_theta=500_000.0,
    moe=MoEConfig(d_model=5120, n_experts=16, top_k=1, d_ff_expert=8192,
                  n_shared=1, d_ff_shared=8192),
)

SMOKE = LMConfig(
    name="llama4-scout-smoke",
    n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab_size=512,
    pattern=("chunked", "chunked", "chunked", "global"),
    attn_chunk=8, rope_on_global=False,
    moe=MoEConfig(d_model=64, n_experts=4, top_k=1, d_ff_expert=32,
                  n_shared=1, d_ff_shared=32),
    dtype=torch.float32,
)

register(Arch(
    name="llama4-scout-17b-a16e", family="lm", cfg=CFG, smoke_cfg=SMOKE,
    shapes=LM_SHAPES,
    notes="iRoPE chunked-local + NoPE-global; 16 routed top-1 + shared expert",
))
