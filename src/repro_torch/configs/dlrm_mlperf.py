"""DLRM MLPerf config (arXiv:1906.00091; paper), PyTorch.

Counterpart of `repro/configs/dlrm_mlperf.py`, field for field: 13 dense
+ 26 sparse (Criteo-1TB cardinalities, MLPerf max_ind_range=40M cap),
embed_dim=128, bot 13-512-256-128, top 1024-1024-512-256-1, dot
interaction.  Row-wise Adagrad keeps optimizer state at 1 fp32/row.  The
CMLS sketch gates admission on the id stream
(examples/recsys_admission_torch.py).
"""
from repro_torch.configs.registry import RECSYS_SHAPES, Arch, register
from repro_torch.models.recsys import DLRMConfig, criteo_tables

CFG = DLRMConfig(
    n_dense=13, embed_dim=128,
    bot_mlp=(13, 512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    table_sizes=tuple(criteo_tables()),
)

SMOKE = DLRMConfig(
    n_dense=13, embed_dim=16,
    bot_mlp=(13, 32, 16),
    top_mlp=(64, 32, 1),
    table_sizes=tuple([64] * 26),
)

register(Arch(
    name="dlrm-mlperf", family="recsys", cfg=CFG, smoke_cfg=SMOKE,
    shapes=RECSYS_SHAPES,
    notes="204M embedding rows after the 40M MLPerf cap (104 GB fp32)",
))
