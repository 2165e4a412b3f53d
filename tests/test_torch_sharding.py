"""The port's GSPMD placement and dry-run accounting against the JAX
package (CPU, one process, no process group).

  * `sharding_for` and the local shard shape of every leaf of every
    registered arch's full-size parameter and optimizer-state specs (the
    LM archs' KV caches at every LM shape too), under all five rule
    tables, on the production axis sizes (16, 16) and (2, 16, 16),
    against the reference's `spec_for` and `NamedSharding.shard_shape`
    on a `jax.sharding.AbstractMesh`;
  * the analytic `model_flops` of all 38 dry-run cells against the
    reference's `_lm_model_flops` / `_recsys_model_flops` /
    `_gnn_model_flops`, equal as floats;
  * the wire bytes of the five collective kinds at group sizes 2, 4 and
    16 against the reference's `collective_bytes` on a synthesized HLO
    line;
  * `roofline/report.py`'s tables against the reference's on the same
    records.
"""
import dataclasses
import json
import os

import jax
import pytest
from jax._src.named_sharding import DuplicateSpecError
from jax.sharding import AbstractMesh, NamedSharding

from repro import sharding as jshard
from repro.configs import registry as jreg
from repro.launch import cells as jcells
from repro.models import dimenet as jdn
from repro.models import recsys as jrs
from repro.models import transformer as jtf
from repro.roofline import analyze as janalyze
from repro.roofline import report as jreport
from repro.train import optimizer as jopt
from repro_torch import sharding
from repro_torch.configs import registry as treg
from repro_torch.launch import cells as tcells
from repro_torch.models import dimenet as tdn
from repro_torch.models import recsys as trs
from repro_torch.models import transformer as ttf
from repro_torch.models.params import _local_shape, flatten
from repro_torch.roofline import analyze as tanalyze
from repro_torch.roofline import report as treport
from repro_torch.train import optimizer as topt

MESHES = {"single": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"lm": jshard.LM_RULES, "decode": jshard.LM_DECODE_RULES,
         "longctx": jshard.LM_LONGCTX_RULES, "recsys": jshard.RECSYS_RULES,
         "gnn": jshard.GNN_RULES}
TRULES = {"lm": sharding.LM_RULES, "decode": sharding.LM_DECODE_RULES,
          "longctx": sharding.LM_LONGCTX_RULES,
          "recsys": sharding.RECSYS_RULES, "gnn": sharding.GNN_RULES}


class _AxisMesh:
    """What `sharding_for` and the local shape read of a `DeviceMesh`
    (names, sizes, rank 0's coordinate), without a process group."""

    def __init__(self, sizes, names):
        self.mesh_dim_names, self._sizes = names, sizes

    def size(self, d):
        return self._sizes[d]

    def get_coordinate(self):
        return [0] * len(self._sizes)


def _spec_trees(family_arch):
    """(port, reference) pairs of spec trees of an arch: its parameters,
    their optimizer state, and for an LM its KV caches at every LM
    shape."""
    name = family_arch
    ja, ta = jreg.get(name), treg.get(name)
    pairs = []
    if ja.family == "lm":
        pairs.append((ttf.param_specs(ta.cfg), jtf.param_specs(ja.cfg)))
        for sp in ja.shapes.values():
            pairs.append((ttf.cache_specs(ta.cfg, sp["batch"], sp["seq"]),
                          jtf.cache_specs(ja.cfg, sp["batch"], sp["seq"])))
    elif ja.family == "gnn":
        for sp in ja.shapes.values():
            kw = ({"readout": "graph", "n_targets": 1} if "batch" in sp else
                  {"readout": "node", "d_feat": sp["d_feat"],
                   "n_targets": sp["n_classes"]})
            pairs.append((tdn.param_specs(dataclasses.replace(ta.cfg, **kw)),
                          jdn.param_specs(dataclasses.replace(ja.cfg, **kw))))
    elif name == "dlrm-mlperf":
        pairs.append((trs.dlrm_specs(ta.cfg), jrs.dlrm_specs(ja.cfg)))
    elif name == "two-tower-retrieval":
        pairs.append((trs.twotower_specs(ta.cfg), jrs.twotower_specs(ja.cfg)))
    else:
        pairs.append((trs.sasrec_specs(ta.cfg), jrs.sasrec_specs(ja.cfg)))
    for tp, jp in list(pairs[:1]):
        pairs.append((topt.opt_state_specs(tp), jopt.opt_state_specs(jp)))
        pairs.append((topt.opt_state_specs(tp, label_fn=lambda p: "table"),
                      jopt.opt_state_specs(jp, label_fn=lambda p: "table")))
    return pairs


def _jleaves(tree):
    from repro.models.params import P as JP

    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in leaves}


def _expected(spec, names):
    """The placements the reference's PartitionSpec stands for: per mesh
    dim, ("shard", i) where dimension i names that mesh axis."""
    out = [("replicate",)] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for n in (entry,) if isinstance(entry, str) else entry:
            out[names.index(n)] = ("shard", i)
    return out


def _kind(p):
    return ("shard", p.dim) if p.is_shard() else ("replicate",)


ARCHS = [a for a, s in treg.all_cells()]
ARCHS = sorted(set(ARCHS), key=ARCHS.index)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_and_shard_shapes_match(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, names)
    tmesh = _AxisMesh(sizes, names)
    n = 0
    for tree_t, tree_j in _spec_trees(arch):
        flat_t, flat_j = flatten(tree_t), _jleaves(tree_j)
        assert list(flat_t) == list(flat_j)
        for path, ts in flat_t.items():
            js = flat_j[path]
            assert tuple(ts.shape) == tuple(js.shape), path
            for key, rules in RULES.items():
                jspec = jshard.spec_for(js.axes, rules, jmesh, js.shape)
                try:
                    want = NamedSharding(jmesh, jspec).shard_shape(js.shape)
                except DuplicateSpecError:  # one mesh axis on two dims
                    with pytest.raises(ValueError, match="shards two"):
                        sharding.sharding_for(ts.axes, TRULES[key], tmesh,
                                              ts.shape)
                    continue
                pl = sharding.sharding_for(ts.axes, TRULES[key], tmesh,
                                           ts.shape)
                assert [_kind(p) for p in pl] == _expected(jspec, names), (
                    path, key)
                assert _local_shape(ts.shape, tmesh, pl) == tuple(want), (
                    path, key)
                n += 1
    assert n > 0


def test_model_flops_of_every_cell_equal_reference():
    cells = treg.all_cells()
    # the same cells; their order follows which config modules loaded first
    assert len(cells) == 38 and sorted(cells) == sorted(jreg.all_cells())
    for arch, shape in cells:
        ja, ta = jreg.get(arch), treg.get(arch)
        sp = ja.shapes[shape]
        if ja.family == "lm":
            got = tcells.lm_model_flops(ta.cfg, sp)
            want = jcells._lm_model_flops(ja.cfg, sp)
        elif ja.family == "recsys":
            got = tcells.recsys_model_flops(ta, ta.cfg, sp)
            want = jcells._recsys_model_flops(ja, ja.cfg, sp)
        else:
            n, e, t = tcells.gnn_sizes(sp)
            kw = ({"readout": "graph", "n_targets": 1} if "batch" in sp else
                  {"readout": "node", "d_feat": sp["d_feat"],
                   "n_targets": sp["n_classes"]})
            got = tdn.model_flops(dataclasses.replace(ta.cfg, **kw), n, e, t,
                                  sp.get("d_feat"))
            want = jcells._gnn_model_flops(dataclasses.replace(ja.cfg, **kw),
                                           n, e, t, sp.get("d_feat"))
        assert isinstance(got, float) and got == want, (arch, shape)


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("kind", tanalyze.KINDS)
def test_wire_bytes_equal_reference_ring_models(kind, n):
    groups = f"replica_groups=[{256 // n},{n}]<=[256]"
    line = (f"  %c = bf16[1024,384]{{1,0}} {kind}(bf16[1024,384]{{1,0}} %p),"
            f" {groups}")
    want = janalyze.collective_bytes(line)
    size = 1024 * 384 * 2
    assert want.count == 1
    assert tanalyze.wire_bytes(kind, size, n) == want.wire_bytes
    assert want.by_op == {kind: want.wire_bytes}


def _records(tmp):
    recs = []
    for i, (arch, shape) in enumerate(treg.all_cells()[:6]):
        for mesh in ("single", "multipod"):
            roof = dataclasses.asdict(tanalyze.Roofline(
                flops=1.5e12 * (i + 1), bytes_accessed=2.5e9 * (i + 2),
                wire_bytes=3e7 * (i + 3), n_devices=256,
                t_compute=1e-3 * i, t_memory=0.02 * (i % 3),
                t_collective=1.2 * (i % 2), bottleneck="memory",
                collectives_by_op={"all-reduce": 1.0},
                model_flops_global=9e14, model_to_hlo_ratio=0.5 + i))
            recs.append({"arch": arch, "shape": shape, "mesh": mesh,
                         "ok": i != 4, "kind": "train",
                         "memory_analysis": {
                             "argument_size_in_bytes": 4e9 * i,
                             "temp_size_in_bytes": 3e9 * i},
                         "variant": "baseline", "temp_bytes": 2.5e9 * i,
                         "roofline": roof})
    for r in recs:
        with open(os.path.join(tmp, f"{r['arch']}__{r['shape']}__"
                                    f"{r['mesh']}.json"), "w") as f:
            json.dump(r, f)


def test_report_tables_equal_reference(tmp_path):
    _records(str(tmp_path))
    d = str(tmp_path)
    for mesh in ("single", "multipod"):
        assert treport.dryrun_table(d, mesh, hbm_bytes=16e9) == \
            jreport.dryrun_table(d, mesh)
    assert treport.perf_table(d) == jreport.perf_table(d)
    assert treport.summary_stats(d) == jreport.summary_stats(d)
    # the card's 80 GB: cells of up to 80 GB resident fit
    rows = treport.dryrun_table(d, "single").splitlines()[2:]
    assert [r.endswith("| Y |") for r in rows] == [True] * len(rows)
