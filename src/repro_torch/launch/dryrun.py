"""Multi-pod dry run: run every (arch x shape) cell once on the
production meshes, on fake tensors, and record memory, FLOPs, bytes and
collectives with the H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun               # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh single                               # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --jobs 6      # in parallel

Counterpart of `repro/launch/dryrun.py`.  The reference lowers and
compiles each cell for 512 placeholder devices; the port runs each
cell's step once, eagerly, as rank 0 of a "fake" process group of 256
(single pod, (16, 16)) or 512 ranks (multi-pod, (2, 16, 16)), on fake
DTensors that allocate nothing (`roofline/op_stats.counting`), so it
needs no card.  A process holds one fake group: `run_cell` makes it,
and tears it down when it made it; `--jobs` runs cells in worker
processes.

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json with
the reference's keys, and are skipped if present (resumable).
`lower_s` is the seconds to build the cell's abstract arguments and
`compile_s` the seconds of its one step (nothing is compiled);
`memory_analysis` comes from the peak of live local storages:
arguments, temporaries (peak less arguments) and outputs (of which
`alias` is the part that is an argument updated in place).  A failure
is recorded and the grid goes on.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import registry

RESULTS = "results/dryrun_torch"


def fake_group(world: int) -> bool:
    """Make the process's "fake" default group of `world` ranks, tearing
    down a fake group of another size.  Returns whether this call made
    it.  A real (gloo / NCCL) group is never replaced."""
    from repro_torch.launch.mesh import init_fake_group

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               f"{dist.get_backend()} group is initialized")
        if dist.get_world_size() == world:
            return False
        dist.destroy_process_group()
    init_fake_group(world)
    return True


def measure(build, mesh, n_devices: int) -> dict:
    """Build a cell with `build(mesh)` and run its step once, counting:
    returns the record's `ok` fields (kind, notes, times,
    memory_analysis, roofline)."""
    from repro_torch.roofline import op_stats
    from repro_torch.roofline.analyze import analyze
    from repro_torch.sharding import use_rules

    t0 = time.time()
    with op_stats.counting() as st:
        cell = build(mesh)
        args_bytes = op_stats.local_bytes(cell.abstract_args)
        arg_ids = {id(getattr(t, "_local_tensor", t))
                   for t in op_stats.tensors(cell.abstract_args)}
        t_build = time.time() - t0
        with use_rules(cell.rules, mesh):
            out = cell.step_fn(*cell.abstract_args)
        t_run = time.time() - t0 - t_build
        outs = [getattr(t, "_local_tensor", t) for t in op_stats.tensors(out)]
        out_bytes = sum(map(op_stats.nbytes, outs))
        alias = sum(op_stats.nbytes(t) for t in outs if id(t) in arg_ids)
        del out, outs
    roof = analyze(st, n_devices=n_devices, model_flops_global=cell.model_flops)
    return dict(
        ok=True, kind=cell.kind, notes=cell.notes,
        lower_s=round(t_build, 1), compile_s=round(t_run, 1),
        memory_analysis={
            "argument_size_in_bytes": int(args_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(max(0, st.peak_bytes - args_bytes)),
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": int(alias)},
        roofline=roof.as_dict(),
    )


def _port_frames(e: BaseException) -> str:
    """The failure's frames inside the port (the line that met an op
    without a strategy sits deep under torch's own frames)."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    return "".join(traceback.format_list(frames[-8:]))


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str = RESULTS,
             force: bool = False) -> dict:
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh

    mesh_name = "multipod" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    record = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False}
    t0 = time.time()
    world = 512 if multi_pod else 256
    made = fake_group(world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        record.update(measure(lambda m: build_cell(arch, shape, m), mesh,
                              world))
    except Exception as e:  # record the failure for triage, don't halt the grid
        record["error"] = f"{type(e).__name__}: {e}"[:4000]
        record["traceback"] = _port_frames(e) + traceback.format_exc()[-1500:]
    finally:
        if made:
            dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    status = "OK" if record["ok"] else "FAIL"
    print(f"[dryrun] {arch:24s} {shape:14s} {mesh_name:8s} {status} "
          f"({time.time()-t0:.0f}s)", flush=True)
    return record


def _job(task):
    return run_cell(*task)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (each holds its own fake group)")
    args = ap.parse_args(argv)

    cells = registry.all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = {"single": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    tasks = [(a, s, mp, args.out, args.force) for a, s in cells
             for mp in meshes]
    if args.jobs > 1:
        import multiprocessing as mp_lib

        with mp_lib.get_context("spawn").Pool(args.jobs,
                                              maxtasksperchild=1) as pool:
            recs = pool.map(_job, tasks, chunksize=1)
    else:
        recs = [_job(t) for t in tasks]
    n_ok = sum(r["ok"] for r in recs)
    print(f"[dryrun] done: {n_ok} ok, {len(recs) - n_ok} failed")


if __name__ == "__main__":
    main()
