"""DimeNet (arXiv:2003.03123; unverified), PyTorch.

Counterpart of `repro/configs/dimenet.py`, field for field:
n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7 n_radial=6.
Four graph regimes (cora-size full batch, reddit-size sampled minibatch,
ogb-products full batch, batched molecules; `GNN_SHAPES`).  Non-molecular
graphs carry synthetic 3D positions; triplets are sampled with a
per-edge angular cap (`data/graph.build_triplets`).
"""
from repro_torch.configs.registry import GNN_SHAPES, Arch, register
from repro_torch.models.dimenet import DimeNetConfig

CFG = DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
                    n_radial=6)

SMOKE = DimeNetConfig(n_blocks=2, d_hidden=32, n_bilinear=4, n_spherical=3,
                      n_radial=4)

register(Arch(
    name="dimenet", family="gnn", cfg=CFG, smoke_cfg=SMOKE,
    shapes=GNN_SHAPES,
    notes="triplet gather regime; segment_sum message passing; sampled "
          "triplet lists capped per edge on large graphs",
))
