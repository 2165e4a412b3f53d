"""Streaming counting plane: the multi-tenant `CountService` (PyTorch),
windowed tenants, and hot/cold tiering (`TierSpec`)."""
from repro_torch.stream.service import CountService, TenantPlane, WindowPlane
from repro_torch.stream.tiering import TierSpec, tier_memory_bytes
from repro_torch.stream.window import WindowedSketch, WindowSpec

__all__ = ["CountService", "TenantPlane", "WindowPlane", "WindowSpec",
           "WindowedSketch", "TierSpec", "tier_memory_bytes"]
