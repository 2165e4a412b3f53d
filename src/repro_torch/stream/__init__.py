"""Streaming counting plane: the multi-tenant `CountService` (PyTorch)."""
from repro_torch.stream.service import CountService, TenantPlane

__all__ = ["CountService", "TenantPlane"]
