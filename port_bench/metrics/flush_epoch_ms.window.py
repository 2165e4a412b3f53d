"""Milliseconds of flush an epoch of the windowed ingest cell (boundary flushes and the epoch's last flush).

Layer: flush epoch (the planes' `flush`, the flush inputs of
`kernels/ops.py`, the heap of `core/topk.py`).  The port's own
`flush_epoch` spans (`obs/trace.py`; each closes at a synchronize, so it
covers the device's work) over the slice run with the tracer on, summed
over both planes and divided by the slice's epochs.  It should move
`window_ingest_events_per_s`.
"""


def read(ctx):
    spans = ctx["spans"].get("flush_epoch")
    return None if not spans else 1e3 * sum(spans) / ctx["units"]
