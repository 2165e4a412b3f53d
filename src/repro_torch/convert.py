"""Carry a counting service's state between the two packages in memory.

The layout is the checkpoint's (`CountService._meta()` / `_tree()`, the
reference's `repro/stream/service.py` layout, manifest v8): a JSON-able
metadata dict and a leaf tree of arrays, with the admission policies in
the metadata.  `service_from_numpy(meta, tree, device)` builds a port
service from the reference's metadata and numpy leaves;
`service_to_numpy(svc)` gives the same layout back, numpy leaves in their
storage dtypes, so two services compare leaf by leaf, byte for byte.  A
tiered service's state rides both ways: the TierSpec and each plane's
membership in the metadata, the cold stores (`cold_tables`) and the
tenant-indexed queue and fill mirrors among the leaves.
"""
from __future__ import annotations

from repro_torch.stream.service import CountService
from repro_torch.train import checkpoint


def service_from_numpy(meta: dict, tree: dict, device=None,
                       engine: str = "auto") -> CountService:
    """A port `CountService` holding the state `meta` + `tree` describe."""
    svc = CountService._from_meta(meta, None, device, engine)
    target = svc._tree(with_topk=meta.get("track_top") is not None)
    svc._load_tree(meta, checkpoint.place(checkpoint.flatten(tree), target))
    return svc


def service_to_numpy(svc: CountService) -> tuple[dict, dict]:
    """(meta, tree) of a port service in the reference's layout."""
    return svc._meta(), checkpoint.to_host(svc._tree())
