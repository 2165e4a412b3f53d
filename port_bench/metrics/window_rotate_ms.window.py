"""Milliseconds of watermark rotation an epoch of the windowed cell.

Layer: window rotation (`stream/window.py`, `ops.window_advance_rows`).
The port's own `window_rotate` spans (each closes at a synchronize) over
the slice run with the tracer on, summed and divided by the slice's
epochs.  It should move `window_ingest_events_per_s`.
"""


def read(ctx):
    spans = ctx["spans"].get("window_rotate")
    return None if not spans else 1e3 * sum(spans) / ctx["units"]
