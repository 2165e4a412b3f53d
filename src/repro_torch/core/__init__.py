"""Core Count-Min-Log sketch library (the paper's contribution), PyTorch."""
from repro_torch.core.counters import CMLS8, CMLS16, CMS32, CounterSpec
from repro_torch.core.sketch import (Sketch, SketchSpec, init, merge, query,
                                     query_state, update, update_batched,
                                     update_exact)

__all__ = [
    "CounterSpec", "CMS32", "CMLS16", "CMLS8",
    "Sketch", "SketchSpec", "init", "query", "query_state",
    "update", "update_exact", "update_batched", "merge",
]
