"""Perf hillclimbing driver: run one cell under a named variant and record
its H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch deepseek-v2-lite-16b --shape train_4k --variant moe_a2a

Counterpart of `repro/launch/hillclimb.py`, with the same `VARIANTS`.
The cell runs as in `launch/dryrun.py` (one step on fake DTensors, rank 0
of a fake group of 256 or 512 ranks); records land in
results/perf_torch/<arch>__<shape>__<variant>__<mesh>.json with the
reference's keys.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch.dryrun import _port_frames, fake_group, measure

RESULTS = "results/perf_torch"


def _replace_cfg(arch, **kw):
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, **kw))


def v_moe_a2a(arch):
    return _replace_cfg(arch, moe=dataclasses.replace(arch.cfg.moe, impl="a2a"))


def v_remat_dots(arch):
    return _replace_cfg(arch, remat="dots")


def v_chunked_attn(arch, chunk=1024):
    return _replace_cfg(arch, chunk_q=chunk)


def v_moe_a2a_chunked(arch):
    return v_chunked_attn(v_moe_a2a(arch))


def v_online_attn(arch, kv_chunk=1024):
    return _replace_cfg(arch, kv_chunk=kv_chunk, chunk_q=None)


def v_moe_a2a_online(arch):
    return v_online_attn(v_moe_a2a(arch))


def v_gnn_local(arch):
    return _replace_cfg(arch, local_triplets=True)


def v_sparse_tables(arch):
    return _replace_cfg(arch, sparse_update=True)


def v_sparse_a2a(arch):
    return _replace_cfg(arch, sparse_update=True, lookup="a2a")


VARIANTS = {
    "baseline": lambda a: a,
    "moe_a2a": v_moe_a2a,
    "remat_dots": v_remat_dots,
    "chunked_attn": v_chunked_attn,
    "moe_a2a_chunked": v_moe_a2a_chunked,
    "online_attn": v_online_attn,
    "moe_a2a_online": v_moe_a2a_online,
    "gnn_local_triplets": v_gnn_local,
    "sparse_tables": v_sparse_tables,
    "sparse_a2a": v_sparse_a2a,
}


def run(arch_name: str, shape: str, variant: str, multi_pod: bool = False,
        out_dir: str = RESULTS, force: bool = False,
        extra: dict | None = None) -> dict:
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh

    mesh_name = "multipod" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"{arch_name}__{shape}__{variant}__{mesh_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    registry.load_all()
    original = registry.ARCHS[arch_name]
    modified = VARIANTS[variant](original)
    if extra:
        modified = _replace_cfg(modified, **extra)
    record = {"arch": arch_name, "shape": shape, "variant": variant,
              "mesh": mesh_name, "ok": False}
    t0 = time.time()
    world = 512 if multi_pod else 256
    made = fake_group(world)
    try:
        registry.ARCHS[arch_name] = modified
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec = measure(lambda m: build_cell(arch_name, shape, m), mesh, world)
        record.update(ok=True, compile_s=round(time.time() - t0, 1),
                      temp_bytes=rec["memory_analysis"]["temp_size_in_bytes"],
                      roofline=rec["roofline"])
    except Exception as e:
        record["error"] = f"{type(e).__name__}: {e}"[:4000]
        record["traceback"] = _port_frames(e) + traceback.format_exc()[-1500:]
    finally:
        registry.ARCHS[arch_name] = original
        if made:
            dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    if record["ok"]:
        r = record["roofline"]
        print(f"[perf] {arch_name}/{shape} {variant:18s} {mesh_name:8s} "
              f"tc={r['t_compute']*1e3:9.1f}ms tm={r['t_memory']*1e3:9.1f}ms "
              f"tn={r['t_collective']*1e3:9.1f}ms "
              f"temp={record['temp_bytes']/1e9:7.2f}GB "
              f"dom={r['bottleneck']}", flush=True)
    else:
        print(f"[perf] {arch_name}/{shape} {variant} FAIL: {record['error']}",
              flush=True)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    run(args.arch, args.shape, args.variant, args.multipod, args.out,
        force=args.force)


if __name__ == "__main__":
    main()
