"""Streaming counting plane (PyTorch): time-scoped sketches (the bucket
ring and its exponential-decay variant), the multi-tenant `CountService`
with its windowed tenants, and hot/cold tiering (`TierSpec`)."""
from repro_torch.stream.window import (DecayedSketch, WindowSpec,
                                       WindowedSketch, decay, decayed_init,
                                       decayed_query, decayed_rotate,
                                       decayed_update, interval_epoch,
                                       interval_lag, window_advance_steps,
                                       window_advance_to, window_init,
                                       window_query, window_query_many,
                                       window_rotate, window_update,
                                       window_weights,
                                       window_weights_stacked)
from repro_torch.stream.service import CountService, TenantPlane, WindowPlane
from repro_torch.stream.tiering import TierSpec, tier_memory_bytes

__all__ = [
    "WindowSpec", "WindowedSketch", "window_init", "window_update",
    "window_rotate", "window_advance_steps", "window_advance_to",
    "window_query", "window_query_many", "window_weights",
    "window_weights_stacked", "interval_epoch", "interval_lag",
    "DecayedSketch", "decay", "decayed_init", "decayed_rotate",
    "decayed_update", "decayed_query",
    "CountService", "TenantPlane", "WindowPlane",
    "TierSpec", "tier_memory_bytes",
]
