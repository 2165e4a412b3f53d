"""Shared set-up of the benchmark's own tests: the benchmark's folder on
the path, and its cells cut to a size the CPU runs in seconds."""
import copy
import dataclasses
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402

CELLS = ("ngram-tracked-ingest", "ngram-window-ingest")
# the scoring-read mix, kept for a later cell: the tracked configuration
# under traffic/ngram_scoring_read.json
READ = "ngram-scoring-read"
MIXES = CELLS + (READ,)


def _cell(name: str) -> spec.Cell:
    if name != READ:
        return spec.find_cell(name, ROOT)
    cell = spec.find_cell(CELLS[0], ROOT)
    traffic = json.loads((BENCH / "traffic/ngram_scoring_read.json")
                         .read_text())
    return dataclasses.replace(
        cell, name=READ, traffic=traffic,
        end_to_end=[{"name": "read_p95_ms", "unit": "ms"},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[{"name": n, "unit": u} for n, u in (
            ("launches_per_read.read", "launches/read"),
            ("query_roofline", "%"), ("idle_share.read", "%"))])


def tiny(name: str) -> spec.Cell:
    """Mix `name` at a CPU size: 3 tenants of width 4,096, rings of
    4,096 keys, 8 microbatches of 512 events, 256 probes a read; the
    shapes of the traffic and the configuration otherwise as they are."""
    cell = _cell(name)
    config = copy.deepcopy(cell.config)
    traffic = copy.deepcopy(cell.traffic)
    config.update(tenants=3, queue_capacity=4096, track_top=8)
    config["sketch"]["width"] = 4096
    config["metrics_plane"]["sketch"]["width"] = 256
    micro = traffic["microbatches"]
    traffic.update(events_per_tenant=4096 // micro if micro > 1 else 256,
                   pool_units=2, warmup_units=2, trace_units=2)
    if traffic.get("metrics_events"):
        traffic["metrics_events"] = 16
    if traffic.get("probes"):
        traffic.update(probes=256, probe_batches=3)
    traffic["check"] = {"tenants": 2, "units_from": 3, "units": 2}
    return dataclasses.replace(cell, config=config, traffic=traffic)
