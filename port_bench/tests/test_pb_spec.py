"""The benchmark's definition: every piece found by name, every name and
unit in the allowed characters, and a new configuration, mix and metric
taken from files alone."""
import json
import re
import shutil

import pytest

from conftest import CELLS, ROOT, tiny
from harness import runner, spec

BENCH = spec.load_benchmark(ROOT)
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_order_of_cells():
    assert set(BENCH) == KEYS
    assert [w["name"] for w in BENCH["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    names += [w[k] for w in BENCH["workloads"]
              for k in ("name", "config", "traffic")]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(NAME.match(n) for n in names + [m["name"] for m in metrics])
    assert all(UNIT.match(m["unit"]) for m in metrics)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_config_and_mix_by_name(cell):
    c = spec.find_cell(cell, ROOT)
    assert c.config["name"] in {x["name"] for x in BENCH["configs"]}
    assert c.traffic["loop"] in ("ingest", "read")
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(spec.load_reader(metric, ROOT))


def test_files_lie_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_each_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in target or w in target["workloads"]


def test_bounds_within_the_contract():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    """A cell on a configuration, a mix and a per-layer metric that exist
    only in this test's files runs from them, untouched code."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = tiny("ngram-tracked-ingest")
    config = dict(base.config, name="tiny-new")
    (tmp_path / "port_bench/configs/tiny-new.json").write_text(
        json.dumps(config))
    mix = dict(base.traffic, microbatches=4, events_per_tenant=1024)
    (tmp_path / "port_bench/traffic/new_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "port_bench/metrics/spans_per_unit.new.py").write_text(
        "def read(ctx):\n"
        "    return sum(map(len, ctx['spans'].values())) / ctx['units']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-new", "source": "test",
                             "file": "port_bench/configs/tiny-new.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new-cell", "config": "tiny-new",
                               "traffic": "new_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "spans_per_unit.new", "unit": "1",
                               "better": "lower", "source": "program_span",
                               "layer": "test", "moves": "setup_s",
                               "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("new-cell", tmp_path)
    assert cell.config["name"] == "tiny-new"
    assert cell.traffic["microbatches"] == 4
    assert [m["name"] for m in cell.per_layer] == ["spans_per_unit.new"]
    out = runner.run(cell, 77, 0.05, True, 0.0, device="cpu", root=tmp_path)
    assert out["correct"]
    assert out["metrics"]["spans_per_unit.new"]["value"] > 0
