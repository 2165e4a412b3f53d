"""Configuration registry, the counterpart of `repro/configs/registry.py`.

Each config module registers an `Arch` with:
  * `cfg`        -- the full-size config;
  * `smoke_cfg`  -- a reduced same-family config for CPU runs;
  * `shapes`     -- the family's input-shape cells.

The port registers the reference's every configuration: the five LM
configurations, DimeNet, the four recommender configurations and the
paper's own sketch configuration (`paper_sketch`).  The shape tables are
the reference's, cell for cell.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional

ARCHS: dict = {}

LM_SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1, "long": True},
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "train", "n_nodes": 2_708, "n_edges": 10_556,
                      "d_feat": 1_433, "n_classes": 7, "max_angular": 8,
                      "readout": "node"},
    "minibatch_lg": {"kind": "train", "batch_nodes": 1_024, "fanout": (15, 10),
                     "base_nodes": 232_965, "base_edges": 114_615_892,
                     "d_feat": 602, "n_classes": 41, "max_angular": 4,
                     "readout": "node", "sampled": True},
    "ogb_products": {"kind": "train", "n_nodes": 2_449_029,
                     "n_edges": 61_859_140, "d_feat": 100, "n_classes": 47,
                     "max_angular": 2, "readout": "node"},
    "molecule": {"kind": "train", "n_nodes": 30, "n_edges": 64, "batch": 128,
                 "max_angular": 8, "readout": "graph"},
}


@dataclasses.dataclass
class Arch:
    name: str
    family: str                      # "lm" | "gnn" | "recsys" | "paper"
    cfg: object
    smoke_cfg: object
    shapes: dict
    skip_shapes: tuple = ()          # e.g. long_500k for pure full-attention
    loss: Optional[Callable] = None  # family default if None
    notes: str = ""


def register(arch: Arch) -> Arch:
    ARCHS[arch.name] = arch
    return arch


_MODULES = [
    "deepseek_v2_lite", "llama4_scout", "phi3_mini", "qwen2_05b", "gemma2_27b",
    "dimenet", "sasrec", "two_tower", "bert4rec", "dlrm_mlperf", "paper_sketch",
]


def load_all() -> dict:
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    return ARCHS


def get(name: str) -> Arch:
    load_all()
    key = name.replace("-", "_").replace(".", "")
    for k, a in ARCHS.items():
        if k == name or k.replace("-", "_").replace(".", "") == key:
            return a
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


def all_cells() -> list:
    """Every (arch, shape) dry-run cell, with documented skips excluded."""
    load_all()
    cells = []
    for a in ARCHS.values():
        if a.family == "paper":
            continue
        for s in a.shapes:
            if s not in a.skip_shapes:
                cells.append((a.name, s))
    return cells
