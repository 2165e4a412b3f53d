"""Build and load the hand-written CUDA kernels (nvcc -> .so -> ctypes).

The sources under `kernels/csrc/` have a plain C interface, so they are
compiled with `nvcc` alone (no PyTorch headers) into one shared library,
loaded with `ctypes`.  The build happens at first use, into
`<repo>/build/kernels/<hash>/`, keyed by a hash of the sources and flags,
so a fresh checkout builds once and an edited source rebuilds.  Each
source compiles in its own `nvcc` process, all started together, then
one link step makes the library.

Flags: sm_90a, -O3, and -fmad=false without fast math, so each float
operation in a kernel rounds once, as written, and an FMA is only where a
kernel writes `__fmaf_rn` (the reference's graph, `csrc/xla_f32.cuh`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]
LIB_NAME = "libcml_kernels.so"

_P, _I, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
SIGNATURES = {
    # tables, t, depth, words_per_row, keys, n, out, seeds, width, bits,
    # log, max_state, logb, bm1, rlogb, rbm1, stream
    "cml_fused_query": [_P, _I, _I, _I, _P, _I, _P, _P, _U, _I, _I, _U, _F,
                        _F, _F, _F, _P],
    # tables, depth, words_per_row, rows, urows, r, keys, mult, n, k1, k2,
    # cand, est, m, seeds, width, bits, log, max_state, logb, bm1, rlogb,
    # rbm1, stream; rows / urows: host int64 (r,) table rows and
    # uniform-grid rows, passed on to the kernels by value; (k1, k2): the
    # flush's threefry key
    "cml_fused_update_score": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _U, _U,
                               _P, _P, _I, _P, _U, _I, _I, _U, _F, _F, _F,
                               _F, _P],
    # tables, depth, words_per_row, rows, r, keys, mult, unif, n, seeds,
    # width, bits, log, max_state, logb, bm1, rlogb, rbm1, stream; rows:
    # host int64 (r,), passed on to the kernel by value
    "cml_fused_update_rows": [_P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _U,
                              _I, _I, _U, _F, _F, _F, _F, _P],
    # tables, depth, words_per_row, rows, urows, t, keys, mult, n, k1, k2,
    # seeds, width, bits, log, max_state, logb, bm1, rlogb, rbm1, stream;
    # rows: host int64 0 .. t-1, urows as above
    "cml_fused_update": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _U, _U, _P, _U,
                         _I, _I, _U, _F, _F, _F, _F, _P],
    # the first two window queries: tables, r, buckets, depth,
    # words_per_row, keys, key_stride (0: one key row for every ring), n,
    # weights, out, mode_max, seeds, width, bits, log, max_state, logb, bm1,
    # rlogb, rbm1, stream
    **{name: [_P, _I, _I, _I, _I, _P, ctypes.c_int64, _I, _P, _P, _I, _P,
              _U, _I, _I, _U, _F, _F, _F, _F, _P]
       for name in ("cml_window_query", "cml_window_query_stacked")},
    # the row-mapped one: tables, r, buckets, depth, words_per_row, rows,
    # keys, n, weights, out, mode_max, seeds, width, bits, log, max_state,
    # logb, bm1, rlogb, rbm1, stream; rows: host int64 (r,), passed on to
    # the kernel by value
    "cml_window_query_stacked_rows": [_P, _I, _I, _I, _I, _P, _P, _I, _P, _P,
                                      _I, _P, _U, _I, _I, _U, _F, _F, _F,
                                      _F, _P],
    # queue, capw, keys, r, n, meta, stream; meta: host int64 (3, r) rows /
    # fill / count, passed on to the kernel by value
    "cml_queue_append": [_P, _I, _P, _I, _I, _P, _P],
    # queue, capw, keys, t, n, meta, stream; meta: host int64 (2, t) fill /
    # count
    "cml_queue_append_dense": [_P, _I, _P, _I, _I, _P, _P],
}

_LIB = None
BUILD_SECONDS: float | None = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels if this source hash has no library yet; return
    the library path.  Parallel per-source nvcc, then one link."""
    global BUILD_SECONDS
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        extra = ["-Xptxas", "-v"] if verbose else []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *ARCH, *FLAGS, *extra, "-I", str(CSRC), "-c",
                   str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for cmd, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
            if verbose and out:
                print(out)
        tmp_lib = pathlib.Path(tmp) / LIB_NAME
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
               *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed: {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
