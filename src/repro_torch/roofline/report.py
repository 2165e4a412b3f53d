"""Render the dry run's tables from results/dryrun_torch and
results/perf_torch records.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dryrun DIR]
        [--perf DIR] [--mesh single|multipod]

Counterpart of `repro/roofline/report.py`, table for table: the records
share the reference's keys, so each package's report reads the other's.
The "fits HBM" column holds the resident bytes (arguments and
temporaries) against one H100's 80 GB (the reference's: a v5e's 16 GB).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.roofline.analyze import HBM_BYTES


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def _fmt_b(x: float) -> str:
    if x >= 1e9:
        return f"{x / 1e9:.1f}GB"
    return f"{x / 1e6:.0f}MB"


def load(dirname: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def dryrun_table(dirname: str = "results/dryrun_torch", mesh: str = "single",
                 hbm_bytes: float = HBM_BYTES) -> str:
    rows = ["| arch | shape | kind | HLO FLOPs/dev | bytes/dev | wire/dev | "
            "t_comp | t_mem | t_coll | bottleneck | model/HLO | fits HBM |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in load(dirname):
        if not r.get("ok") or r["mesh"] != mesh:
            continue
        ro = r["roofline"]
        ma = r.get("memory_analysis", {})
        resident = (ma.get("argument_size_in_bytes", 0)
                    + ma.get("temp_size_in_bytes", 0))
        ratio = ro.get("model_to_hlo_ratio", 0)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r.get('kind','')} "
            f"| {ro['flops']:.2e} | {_fmt_b(ro['bytes_accessed'])} "
            f"| {_fmt_b(ro['wire_bytes'])} | {_fmt_s(ro['t_compute'])} "
            f"| {_fmt_s(ro['t_memory'])} | {_fmt_s(ro['t_collective'])} "
            f"| {ro['bottleneck']} | {ratio:.2f} "
            f"| {'Y' if resident <= hbm_bytes else 'N'} |")
    return "\n".join(rows)


def perf_table(dirname: str = "results/perf_torch") -> str:
    rows = ["| cell | variant | mesh | t_comp | t_mem | t_coll | max term | "
            "temp | bottleneck |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in load(dirname):
        if not r.get("ok"):
            continue
        ro = r["roofline"]
        mx = max(ro["t_compute"], ro["t_memory"], ro["t_collective"])
        rows.append(
            f"| {r['arch']}/{r['shape']} | {r['variant']} | {r['mesh']} "
            f"| {_fmt_s(ro['t_compute'])} | {_fmt_s(ro['t_memory'])} "
            f"| {_fmt_s(ro['t_collective'])} | **{_fmt_s(mx)}** "
            f"| {r['temp_bytes'] / 1e9:.2f}GB | {ro['bottleneck']} |")
    return "\n".join(rows)


def summary_stats(dirname: str = "results/dryrun_torch") -> dict:
    recs = [r for r in load(dirname) if r.get("ok")]
    return {
        "n_ok": len(recs),
        "n_single": sum(r["mesh"] == "single" for r in recs),
        "n_multipod": sum(r["mesh"] == "multipod" for r in recs),
        "bottlenecks": {b: sum(r["roofline"]["bottleneck"] == b for r in recs
                               if r["mesh"] == "single")
                        for b in ("compute", "memory", "collective")},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun_torch")
    ap.add_argument("--perf", default="results/perf_torch")
    ap.add_argument("--mesh", default="single", choices=["single", "multipod"])
    args = ap.parse_args(argv)
    print(dryrun_table(args.dryrun, args.mesh))
    print()
    print(perf_table(args.perf))
    print(summary_stats(args.dryrun))


if __name__ == "__main__":
    main()
