"""The port's dry run (`launch/dryrun.py`, `launch/hillclimb.py`,
`roofline/op_stats.py`) on a fake 256-rank group (CPU, no card).

One subprocess (`python tests/test_torch_dryrun.py --child DIR`: a
process holds one fake group) runs, as rank 0 of a "fake" group of 256
ranks on the (16, 16) production mesh:

  * `run_cell` on four small cells (qwen2-0.5b decode_32k, sasrec
    serve_p99, dlrm-mlperf serve_p99, dimenet molecule), each `ok` with
    the reference's record keys;
  * the per-device FLOPs of a matmul sharded 16 x 16: 1/256 of its
    global FLOPs; of a replicated one: all of them; the wire bytes of a
    DTensor all-gather over the "data" axis (16 ranks 16 apart, so
    across hosts) and of a shard-to-shard redistribution over the
    "model" axis (an all-to-all of 16 ranks, across two hosts): the
    ring models';
  * the bytes of a lookup into a 512 MB table: its indices, the rows it
    reads and its output, not the table;
  * one `hillclimb.run` variant (dimenet molecule, gnn_local_triplets:
    the routed loss on local shards).
"""
import json
import os
import subprocess
import sys

import pytest

CELLS = [("qwen2-0.5b", "decode_32k"), ("sasrec", "serve_p99"),
         ("dlrm-mlperf", "serve_p99"), ("dimenet", "molecule")]
LOOKUPS = ("embedding", "embedding_bag", "index_select", "index")
RECORD_KEYS = {"arch", "shape", "mesh", "ok", "kind", "notes", "lower_s",
               "compile_s", "memory_analysis", "roofline"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes"}
ROOFLINE_KEYS = {"flops", "bytes_accessed", "wire_bytes", "n_devices",
                 "t_compute", "t_memory", "t_collective", "bottleneck",
                 "collectives_by_op", "peak_memory_bytes", "raw_flops",
                 "raw_bytes", "model_flops_global", "model_to_hlo_ratio",
                 "n_whiles"}


def child(out: str) -> None:
    import torch
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.params import P, abstract_tree
    from repro_torch.roofline import op_stats
    from repro_torch.roofline.analyze import wire_bytes

    dryrun.fake_group(256)
    res = {"cells": [dryrun.run_cell(a, s, False, out, force=True)
                     for a, s in CELLS]}
    mesh = make_production_mesh()
    rules = {"rows": "data", "cols": "model"}
    for name, axes in (("sharded", (("rows", None), (None, "cols"))),
                       ("replicated", (None, None))):
        with op_stats.counting() as st:
            t = abstract_tree({"x": P((256, 4096), axes[0]),
                               "w": P((4096, 8192), axes[1])}, rules, mesh)
            y = t["x"] @ t["w"]
        res[name] = {"flops": st.flops, "local": list(y.to_local().shape)}
    with op_stats.counting() as st:
        x = abstract_tree(P((256, 4096), ("rows", None)), rules, mesh)
        x.redistribute(mesh, [Replicate(), Replicate()])
    res["gather"] = {"inter": st.wire_inter, "intra": st.wire_intra,
                     "by_op": st.wire_by_op,
                     "want": wire_bytes("all-gather", 256 * 4096 * 4, 16)}
    assert isinstance(x.placements[0], Shard)
    with op_stats.counting() as st:
        x = abstract_tree(P((256, 4096), ("rows", None)), {"rows": "model"},
                          mesh)
        y = x.redistribute(mesh, [Replicate(), Shard(1)])
    res["alltoall"] = {"inter": st.wire_inter, "intra": st.wire_intra,
                       "by_op": st.wire_by_op,
                       "local": list(y.to_local().shape),
                       "want": wire_bytes("all-to-all", 16 * 4096 * 4, 16)}
    res["lookup"] = {}
    for op in LOOKUPS:
        with op_stats.counting() as st:
            table = torch.empty(1_000_000, 128)
            idx = torch.zeros(512, dtype=torch.int64)
            before = st.bytes
            got = {"embedding": lambda: F.embedding(idx, table),
                   "embedding_bag": lambda: F.embedding_bag(
                       idx, table, torch.arange(0, 512, 4), mode="sum"),
                   "index_select": lambda: table.index_select(0, idx),
                   "index": lambda: table[idx]}[op]()
            res["lookup"][op] = {"bytes": st.bytes - before,
                                 "table": op_stats.nbytes(table),
                                 "rows": 512 * 128 * 4,
                                 "idx": op_stats.nbytes(idx),
                                 "out": op_stats.nbytes(got)}
    res["hillclimb"] = hillclimb.run("dimenet", "molecule",
                                     "gnn_local_triplets", out_dir=out,
                                     force=True)
    with open(os.path.join(out, "child.json"), "w") as f:
        json.dump(res, f)
    del torch


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", out], env=env, capture_output=True,
                          text=True, timeout=170)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(out, "child.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_cell_runs_with_reference_keys(result, i):
    rec = result["cells"][i]
    assert (rec["arch"], rec["shape"]) == CELLS[i]
    assert rec["ok"], rec.get("error")
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    ro = rec["roofline"]
    assert set(ro) == ROOFLINE_KEYS
    assert ro["n_devices"] == 256 and ro["flops"] > 0
    assert ro["bytes_accessed"] > 0 and ro["model_flops_global"] > 0
    assert ro["peak_memory_bytes"] >= rec["memory_analysis"][
        "argument_size_in_bytes"] > 0
    assert max(ro["t_compute"], ro["t_memory"], ro["t_collective"]) == \
        {"compute": ro["t_compute"], "memory": ro["t_memory"],
         "collective": ro["t_collective"]}[ro["bottleneck"]]


def test_sharded_matmul_counts_its_local_flops(result):
    glob = 2.0 * 256 * 4096 * 8192
    assert result["sharded"]["flops"] == glob / 256
    assert result["sharded"]["local"] == [16, 512]
    assert result["replicated"]["flops"] == glob


def test_all_gather_wire_bytes_follow_the_ring_model(result):
    g = result["gather"]
    assert g["intra"] == 0.0  # a "data" group spans 16 hosts
    assert g["inter"] == g["want"] == g["by_op"]["all-gather"]


def test_shard_to_shard_wire_bytes_follow_the_all_to_all_model(result):
    a = result["alltoall"]
    assert a["local"] == [256, 256]
    assert a["intra"] == 0.0  # a "model" group of 16 spans two hosts
    assert a["inter"] == a["want"] == a["by_op"]["all-to-all"]
    assert set(a["by_op"]) == {"all-to-all"}


@pytest.mark.parametrize("op", LOOKUPS)
def test_lookup_is_charged_its_rows_not_its_table(result, op):
    lk = result["lookup"][op]
    if op == "embedding_bag":  # offsets, sums and bag bookkeeping beside
        assert lk["idx"] + lk["rows"] + lk["out"] <= lk["bytes"] \
            <= lk["idx"] + 2 * lk["rows"] + lk["out"]
    else:
        assert lk["bytes"] == lk["idx"] + lk["rows"] + lk["out"]
    assert lk["bytes"] * 100 < lk["table"]


def test_hillclimb_variant_runs(result):
    rec = result["hillclimb"]
    assert rec["ok"], rec.get("error")
    assert rec["variant"] == "gnn_local_triplets"
    assert rec["roofline"]["flops"] > 0 and rec["temp_bytes"] >= 0


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    child(sys.argv[2])
