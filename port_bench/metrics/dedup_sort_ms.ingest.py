"""Milliseconds an epoch of the tracked flush's dedup.

Layer: flush epoch (`kernels/ops.py` `update_score_rows`: the weighted
dedup's int64 sorts and segment sum, `core/sketch.py`
`dedup_weighted`).  The port's own `dedup` spans (`obs/trace.py`; with
the tracer on each closes at a synchronize, and the spans before it in
the flush do too, so it covers the sorts' device work) over the slice
run with the tracer on, divided by the slice's epochs.  It should move
`ingest_events_per_s`.
"""


def read(ctx):
    spans = ctx["spans"].get("dedup")
    return None if not spans else 1e3 * sum(spans) / ctx["units"]
