"""Two-tower retrieval (Yi et al., RecSys'19 YouTube; unverified), PyTorch.

Counterpart of `repro/configs/two_tower.py`, field for field:
embed_dim=256, towers 1024-512-256, dot scoring, in-batch sampled softmax
with logQ correction.  The logQ term uses item-frequency estimates from
the CMLS sketch: the paper's counting structure in its production
retrieval role.
"""
from repro_torch.configs.registry import RECSYS_SHAPES, Arch, register
from repro_torch.models.recsys import TwoTowerConfig

CFG = TwoTowerConfig(n_users=5_000_000, n_items=1_000_000, embed_dim=256,
                     tower=(1024, 512, 256))

SMOKE = TwoTowerConfig(n_users=1_000, n_items=1_000, embed_dim=32,
                       tower=(64, 32))

register(Arch(
    name="two-tower-retrieval", family="recsys", cfg=CFG, smoke_cfg=SMOKE,
    shapes=RECSYS_SHAPES,
    notes="sampled-softmax retrieval; sketch-driven logQ correction",
))
