"""Host-to-device uploads that never synchronize: reused pinned host slots.

A flush needs a few small host arrays on the card: its active rows and
their fills, the uniform draw's row offsets, the window weights, the
rotation's cleared buckets.  `torch.from_numpy(a).to("cuda")` copies
from pageable memory and waits for the copy (one `cudaStreamSynchronize`
each).  `HostStaging` packs the arrays into the next of its reused host
slots (pinned on CUDA), copies them with `non_blocking=True`, and records
a CUDA event behind the copy.  A slot is packed again only after its
event has passed, so the host waits only when it runs a whole ring of
slots ahead of the card.  On the CPU the same packing fills plain host
slots.

Two ways to use a staging:

  * `stage` + `send`: pack into the next slot, then copy into a device
    buffer the caller owns (the ingest ring, `stream/service.py`, reuses
    one device buffer for its keys);
  * `upload`: pack several arrays into one slot and copy them into one
    fresh device tensor from torch's caching allocator (the flush's
    inputs, which later ops of the same flush read).

`upload(device, *arrays)` goes through one shared staging per device,
which the tracked, untracked and windowed planes' flushes all use.

Each staged slot counts into the active scopes (`obs/scope.py`):
`upload_bytes`, the bytes packed for the device, and `uploads`, one a
slot (on CUDA each is one copy; on the CPU the ingest ring reads its
slot in place).  A slot whose last copy has not passed counts one
`staging_waits` and waits inside a `staging_wait` span.  These
`COUNTERS` describe this process's uploads, not a sketch's state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs import scope, trace

ALIGN = 8  # bytes: every packed array starts at a multiple of this
COUNTERS = ("upload_bytes", "uploads", "staging_waits")


class HostStaging:
    """A ring of reused host slots (pinned on CUDA) for uploads to
    `device`; slot tensors have dtype `dtype` and grow to the largest
    packing they have carried."""

    def __init__(self, device, slots: int = 32, dtype=torch.uint8):
        self.device = torch.device(device)
        self.dtype = dtype
        self._itemsize = torch.empty(0, dtype=dtype).element_size()
        self._cuda = self.device.type == "cuda"
        self.host = [torch.empty(0, dtype=dtype) for _ in range(slots)]
        self._copied = ([torch.cuda.Event() for _ in range(slots)]
                        if self._cuda else None)
        self._slot = 0
        self._last = 0

    def stage(self, size: int) -> torch.Tensor:
        """The first `size` elements of the next slot, free to pack: its
        last copy has been read (waiting for it only if it has not)."""
        slot = self._slot
        self._slot = (slot + 1) % len(self.host)
        self._last = slot
        if self._cuda and not self._copied[slot].query():
            scope.count("staging_waits")
            with trace.span("staging_wait"):
                self._copied[slot].synchronize()
        scope.count("uploads")
        scope.count("upload_bytes", size * self._itemsize)
        if self.host[slot].numel() < size:
            self.host[slot] = torch.empty(size, dtype=self.dtype,
                                          pin_memory=self._cuda)
        return self.host[slot][:size]

    def send(self, host: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """Copy the slot view `host` (from the last `stage`) into `dst`
        without waiting; returns `dst`."""
        dst.copy_(host, non_blocking=True)
        if self._cuda:
            self._copied[self._last].record(
                torch.cuda.current_stream(self.device))
        return dst

    def upload(self, *arrays) -> list[torch.Tensor]:
        """Each array as a tensor of its dtype and shape on the device,
        all packed into one slot and copied in one transfer."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // ALIGN) * ALIGN
        host = self.stage(total)
        packed = host.numpy()
        for a, off in zip(arrays, offsets):
            packed[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = self.send(host, torch.empty(total, dtype=torch.uint8,
                                          device=self.device))
        return [dev[off:off + a.nbytes].view(_torch_dtype(a.dtype))
                .view(a.shape) for a, off in zip(arrays, offsets)]


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


_SHARED: dict[torch.device, HostStaging] = {}


def upload(device, *arrays) -> list[torch.Tensor]:
    """`HostStaging.upload` through the shared staging of `device`."""
    device = torch.device(device)
    staging = _SHARED.get(device)
    if staging is None:
        staging = _SHARED[device] = HostStaging(device)
    return staging.upload(*arrays)
