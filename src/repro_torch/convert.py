"""Carry a counting service's state between the two packages.

The layout is the reference's checkpoint layout
(`repro/stream/service.py` `_meta()` / `_tree()`): a JSON-able metadata
dict and a leaf tree of arrays.  Per plane the leaves are `tables` (the
storage layout and dtype), the ring `queue`, its `fill`, and, when the
service tracks heavy hitters, `topk.{keys, estimates, filled}`; a window
plane's `tables` is its (T, B, d, w) leaf, beside the `cursor` and
`epoch` (-1: no watermark yet) mirrors.  The plane's PRNG lane position
is its `rng_draws` entry in the metadata.

`service_from_numpy(meta, tree, device)` builds a port service from the
reference's metadata and numpy leaves; `service_to_numpy(svc)` gives the
same layout back, so the two services compare leaf by leaf, byte for
byte.  Only what this slice of the port serves converts: plain and
window planes, tracked or not, without tiering or admission.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.counters import CounterSpec, from_numpy, to_numpy
from repro_torch.core.sketch import SketchSpec
from repro_torch.core.topk import TopK
from repro_torch.stream.service import CountService
from repro_torch.stream.window import WindowSpec

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


def _window_spec(wm: dict) -> WindowSpec:
    return WindowSpec(sketch=spec_from_meta(wm["sketch"]),
                      buckets=wm["buckets"], interval=wm["interval"])


def _load_plane(plane, pm: dict, leaf: dict, dev) -> None:
    if list(plane.names) != list(pm["tenants"]):
        raise ValueError(f"plane tenant order {plane.names} differs from "
                         f"the metadata's {pm['tenants']}")
    tables = np.asarray(leaf["tables"])
    want = plane.tables
    if tables.shape != tuple(want.shape) or \
            tables.dtype != to_numpy(want[:0]).dtype:
        raise ValueError(f"tables leaf {tables.dtype}{tables.shape} does "
                         f"not match the plane's storage "
                         f"{want.dtype}{tuple(want.shape)}")
    plane.tables = from_numpy(tables, dev)
    plane.ring.queue = from_numpy(np.asarray(leaf["queue"], np.uint32), dev)
    plane.ring.fill = np.asarray(leaf["fill"], np.int64).copy()
    if plane.tracker is not None:
        tk = leaf["topk"]
        plane.tracker = TopK(
            keys=from_numpy(np.asarray(tk["keys"], np.uint32), dev),
            estimates=from_numpy(np.asarray(tk["estimates"], np.float32),
                                 dev),
            filled=from_numpy(np.asarray(tk["filled"], bool), dev))
    plane.rng.draws = int(pm["rng_draws"])


def service_from_numpy(meta: dict, tree: dict, device=None,
                       engine: str = "auto") -> CountService:
    """A port `CountService` holding the state `meta` + `tree` describe."""
    for key in ("tier", "admission"):
        if meta.get(key):
            raise NotImplementedError(
                f"not in this slice of the port: {key!r} state")
    default = spec_from_meta(meta["spec"]) if "spec" in meta else None
    svc = CountService(default, queue_capacity=meta["queue_capacity"],
                       seed=meta["seed"], track_top=meta["track_top"],
                       device=device, engine=engine)
    where = {}
    for pm in meta["planes"]:
        where.update({n: dict(spec=spec_from_meta(pm["spec"]))
                      for n in pm["tenants"]})
    for wm in meta.get("windows", []):
        where.update({n: dict(window=_window_spec(wm))
                      for n in wm["tenants"]})
    for name in meta["tenant_order"]:
        svc.add_tenant(name, **where[name])
    dev = svc.device
    for pm, leaf in zip(meta["planes"], tree["planes"]):
        _load_plane(svc._planes[spec_from_meta(pm["spec"])], pm, leaf, dev)
    for wm, leaf in zip(meta.get("windows", []), tree.get("windows", [])):
        plane = svc._wplanes[_window_spec(wm)]
        _load_plane(plane, wm, leaf, dev)
        plane.cursors = np.asarray(leaf["cursor"], np.int32).copy()
        plane.epochs = [None if e < 0 else int(e)
                        for e in np.asarray(leaf["epoch"]).tolist()]
    if "metrics" in meta:
        svc.metrics.load(meta["metrics"])
    else:
        svc.stats = meta.get("stats", {})
    return svc


def _plane_leaf(p) -> dict:
    leaf = {"tables": to_numpy(p.tables), "queue": to_numpy(p.ring.queue),
            "fill": p.ring.fill.astype(np.int32)}
    if p.tracker is not None:
        tk = p.tracker
        leaf["topk"] = {"keys": to_numpy(tk.keys),
                        "estimates": tk.estimates.detach().cpu().numpy(),
                        "filled": tk.filled.detach().cpu().numpy()}
    return leaf


def service_to_numpy(svc: CountService) -> tuple[dict, dict]:
    """(meta, tree) of a port service in the reference's layout, numpy
    leaves in their storage dtypes."""
    planes = list(svc._planes.values())
    windows = list(svc._wplanes.values())
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
                    "rng_draws": p.rng.draws} for p in planes],
        "windows": [{"sketch": spec_meta(p.spec), "buckets": p.wspec.buckets,
                     "interval": p.wspec.interval, "tenants": list(p.names),
                     "rng_draws": p.rng.draws} for p in windows],
    }
    if svc.default_spec is not None:
        meta["spec"] = spec_meta(svc.default_spec)
        meta["tenants"] = svc.tenants
    wleaves = []
    for p in windows:
        leaf = {"cursor": p.cursors.astype(np.int32),
                "epoch": np.asarray([-1 if e is None else e
                                     for e in p.epochs], np.int32)}
        leaf.update(_plane_leaf(p))
        wleaves.append(leaf)
    return meta, {"planes": [_plane_leaf(p) for p in planes],
                  "windows": wleaves}
