"""Streaming counting plane: the multi-tenant `CountService` (PyTorch)."""
from repro_torch.stream.service import CountService, TenantPlane, WindowPlane
from repro_torch.stream.window import WindowedSketch, WindowSpec

__all__ = ["CountService", "TenantPlane", "WindowPlane", "WindowSpec",
           "WindowedSketch"]
