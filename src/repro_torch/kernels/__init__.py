"""Hand-written CUDA kernels for the sketch hot path.

kernels/csrc/*.cu — the kernels (CUDA C++, sm_90a, plain C interface)
kernels/build.py  — nvcc build at first use + ctypes loader
kernels/sketch.py — one checked wrapper per kernel, with launch counts
kernels/ref.py    — the plain PyTorch version of each kernel
kernels/ops.py    — public ops (dispatch audit, engines, ingest ring)
"""
