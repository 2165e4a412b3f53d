"""BERT4Rec (arXiv:1904.06690; paper), PyTorch.

Counterpart of `repro/configs/bert4rec.py`, field for field:
embed_dim=64, 2 blocks, 2 heads, seq_len=200, bidirectional encoder with
masked-item training (mask prob 0.15, mask token = n_items).
Encoder-only: there is no decode step.
"""
from repro_torch.configs.registry import RECSYS_SHAPES, Arch, register
from repro_torch.models.recsys import SASRecConfig

CFG = SASRecConfig(n_items=1_000_000, embed_dim=64, n_blocks=2, n_heads=2,
                   seq_len=200, n_neg=512, causal=False, mask_frac=0.15)

SMOKE = SASRecConfig(n_items=500, embed_dim=16, n_blocks=2, n_heads=2,
                     seq_len=24, n_neg=16, causal=False, mask_frac=0.15)

register(Arch(
    name="bert4rec", family="recsys", cfg=CFG, smoke_cfg=SMOKE,
    shapes=RECSYS_SHAPES,
    notes="bidirectional masked-item model; shares the encoder with sasrec",
))
