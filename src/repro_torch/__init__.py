"""PyTorch + CUDA port of the Count-Min-Log counting system.

A package of its own beside the JAX reference `repro`: it imports torch,
numpy and the standard library only, never `jax` or `repro`.  Module
paths mirror the reference (`core/`, `kernels/`, `obs/`, `stream/`,
`launch/`), so each counterpart sits at the same relative path.  Entry
points run on CUDA unless the caller passes `device="cpu"`.
"""
