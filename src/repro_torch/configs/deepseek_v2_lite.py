"""DeepSeek-V2-Lite 16B (arXiv:2405.04434; hf), PyTorch.

Counterpart of `repro/configs/deepseek_v2_lite.py`, field for field: 27L
d_model=2048 16H MLA(kv_lora=512) vocab=102400, MoE top-6 + 2 shared,
expert d_ff=1408, first layer dense (d_ff=10944); 64 routed experts, the
Lite HF config (160 routed is the full V2).
"""
import torch

from repro_torch.configs.registry import LM_SHAPES, Arch, register
from repro_torch.models.attention import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=10944, vocab_size=102_400,
    attn_kind="mla",
    mla=MLAConfig(d_model=2048, n_heads=16, kv_lora=512, qk_nope=128,
                  qk_rope=64, v_dim=128),
    moe=MoEConfig(d_model=2048, n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared=2, norm_topk=True),
    n_dense_prefix=1, d_ff_prefix=10944,
    pattern=("global",) * 2,   # 26 MoE layers in groups of two
)

SMOKE = LMConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=512,
    attn_kind="mla",
    mla=MLAConfig(d_model=64, n_heads=4, kv_lora=32, qk_nope=16, qk_rope=8,
                  v_dim=16),
    moe=MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff_expert=32,
                  n_shared=2, norm_topk=True),
    n_dense_prefix=1, d_ff_prefix=96,
    pattern=("global",), dtype=torch.float32,
)

register(Arch(
    name="deepseek-v2-lite-16b", family="lm", cfg=CFG, smoke_cfg=SMOKE,
    shapes=LM_SHAPES,
    notes="MLA absorbed decode; 64 routed experts per HF config (see module doc)",
))
