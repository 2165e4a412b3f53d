"""Milliseconds an epoch drawing the windowed flush's uniforms.

Layer: flush epoch (`kernels/ops.py` `_parity_uniforms`,
`core/prng.py`: the threefry draw the row-mapped update, kernel 6,
takes from the host side as elementwise device passes).  The port's own
`uniforms` spans (`obs/trace.py`; with the tracer on each closes at a
synchronize, and the dedup before it does too, so it covers the draw's
device work) over the slice run with the tracer on, divided by the
slice's epochs.  It should move `window_ingest_events_per_s`.
"""


def read(ctx):
    spans = ctx["spans"].get("uniforms")
    return None if not spans else 1e3 * sum(spans) / ctx["units"]
