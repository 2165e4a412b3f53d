"""Carry a counting service's state between the two packages.

The layout is the reference's checkpoint layout
(`repro/stream/service.py` `_meta()` / `_tree()`): a JSON-able metadata
dict and a leaf tree of arrays.  Per plane the leaves are `tables` (the
storage layout and dtype), the ring `queue`, its `fill`, and
`topk.{keys, estimates, filled}`; the plane's PRNG lane position is its
`rng_draws` entry in the metadata.

`service_from_numpy(meta, tree, device)` builds a port service from the
reference's metadata and numpy leaves; `service_to_numpy(svc)` gives the
same layout back, so the two services compare leaf by leaf, byte for
byte.  Only what this slice of the port serves converts: plain tracked
planes without tiering, windows or admission.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.counters import CounterSpec, from_numpy, to_numpy
from repro_torch.core.sketch import SketchSpec
from repro_torch.core.topk import TopK
from repro_torch.stream.service import CountService

VERSION = 8


def spec_meta(spec: SketchSpec) -> dict:
    c = spec.counter
    return {"width": spec.width, "depth": spec.depth, "seed": spec.seed,
            "packed": spec.packed,
            "counter": {"kind": c.kind, "base": c.base, "bits": c.bits}}


def spec_from_meta(meta: dict) -> SketchSpec:
    return SketchSpec(width=meta["width"], depth=meta["depth"],
                      seed=meta["seed"], packed=meta.get("packed", False),
                      counter=CounterSpec(**meta["counter"]))


def service_from_numpy(meta: dict, tree: dict, device=None,
                       engine: str = "auto") -> CountService:
    """A port `CountService` holding the state `meta` + `tree` describe."""
    for key in ("windows", "tier", "admission"):
        if meta.get(key):
            raise NotImplementedError(
                f"not in this slice of the port: {key!r} state")
    default = spec_from_meta(meta["spec"]) if "spec" in meta else None
    svc = CountService(default, queue_capacity=meta["queue_capacity"],
                       seed=meta["seed"], track_top=meta["track_top"],
                       device=device, engine=engine)
    plane_meta = {name: pm for pm in meta["planes"] for name in pm["tenants"]}
    for name in meta["tenant_order"]:
        svc.add_tenant(name, spec=spec_from_meta(plane_meta[name]["spec"]))
    dev = svc.device
    for pm, leaf in zip(meta["planes"], tree["planes"]):
        plane = svc._planes[spec_from_meta(pm["spec"])]
        if list(plane.names) != list(pm["tenants"]):
            raise ValueError(f"plane tenant order {plane.names} differs "
                             f"from the metadata's {pm['tenants']}")
        tables = np.asarray(leaf["tables"])
        want = plane.tables
        if tables.shape != tuple(want.shape) or \
                tables.dtype != to_numpy(want[:0]).dtype:
            raise ValueError(f"tables leaf {tables.dtype}{tables.shape} does "
                             f"not match the plane's storage "
                             f"{want.dtype}{tuple(want.shape)}")
        plane.tables = from_numpy(tables, dev)
        plane.ring.queue = from_numpy(np.asarray(leaf["queue"], np.uint32),
                                      dev)
        plane.ring.fill = np.asarray(leaf["fill"], np.int64).copy()
        tk = leaf["topk"]
        plane.tracker = TopK(
            keys=from_numpy(np.asarray(tk["keys"], np.uint32), dev),
            estimates=from_numpy(np.asarray(tk["estimates"], np.float32),
                                 dev),
            filled=from_numpy(np.asarray(tk["filled"], bool), dev))
        plane.rng.draws = int(pm["rng_draws"])
    if "metrics" in meta:
        svc.metrics.load(meta["metrics"])
    else:
        svc.stats = meta.get("stats", {})
    return svc


def service_to_numpy(svc: CountService) -> tuple[dict, dict]:
    """(meta, tree) of a port service in the reference's layout, numpy
    leaves in their storage dtypes."""
    meta = {
        "version": VERSION,
        "queue_capacity": svc.queue_capacity,
        "seed": svc.seed,
        "track_top": svc.track_top,
        "tenant_order": svc.tenants,
        "stats": dict(svc.stats),
        "metrics": svc.metrics.snapshot(),
        "admission": {},
        "planes": [{"spec": spec_meta(p.spec), "tenants": list(p.names),
                    "rng_draws": p.rng.draws} for p in svc.planes],
        "windows": [],
    }
    if svc.default_spec is not None:
        meta["spec"] = spec_meta(svc.default_spec)
        meta["tenants"] = svc.tenants
    planes = []
    for p in svc.planes:
        tk = p.tracker
        planes.append({
            "tables": to_numpy(p.tables),
            "queue": to_numpy(p.ring.queue),
            "fill": p.ring.fill.astype(np.int32),
            "topk": {"keys": to_numpy(tk.keys),
                     "estimates": tk.estimates.detach().cpu().numpy(),
                     "filled": tk.filled.detach().cpu().numpy()},
        })
    return meta, {"planes": planes, "windows": []}

