"""Run one cell of the benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  It sets up the port's CountService for the
cell's configuration (src/repro_torch), warms it up, measures for
--seconds, checks what the window produced against the reference under
port_bench/reference, and prints one JSON line: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1
its per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`checks`, each number compared beside its limit (also the last lines of
standard error).  A run that finds no CUDA card, or fewer than the cell
asks for, or JAX or the JAX package loaded once the window has closed,
exits with code 2 and prints no result.  Kernel build caches stay in the
checkout's build/.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
# one producer or one client, a process with few threads: the host's
# other cores stay free, so runs disturb each other less
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT / "src"), str(HERE)]


def fail(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the check's own proof: the control (the reference with a
    # guarantee broken) in the program's place
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    from harness import runner, spec

    cell = spec.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        T_START, device="cuda", control=args.control,
                        root=ROOT)
    found = result.pop("forbidden")
    if found:
        fail(f"modules of JAX or the JAX package loaded: {found}")
    result["device"]["power_limit"] = power_limit()
    print(f"[port_bench] correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[port_bench] check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
