"""SASRec (arXiv:1808.09781; paper), PyTorch.

Counterpart of `repro/configs/sasrec.py`, field for field: embed_dim=50,
2 blocks, 1 head, seq_len=50, causal self-attention over the session.
Catalogue scaled to 1M items (the retrieval_cand shape demands 10^6
candidates); training uses sampled softmax (512 negatives).
"""
from repro_torch.configs.registry import RECSYS_SHAPES, Arch, register
from repro_torch.models.recsys import SASRecConfig

CFG = SASRecConfig(n_items=1_000_000, embed_dim=50, n_blocks=2, n_heads=1,
                   seq_len=50, n_neg=512, causal=True)

SMOKE = SASRecConfig(n_items=500, embed_dim=16, n_blocks=2, n_heads=1,
                     seq_len=20, n_neg=16, causal=True)

register(Arch(
    name="sasrec", family="recsys", cfg=CFG, smoke_cfg=SMOKE,
    shapes=RECSYS_SHAPES,
    notes="self-attn sequential recommender; sampled softmax vs 1M items",
))
