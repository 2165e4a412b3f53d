"""Milliseconds an epoch of the tracked flush's heavy-hitter tracker.

Layer: flush epoch (the tracker, `core/topk.py`): each fill class's
candidate union (`tracker_candidates`) and the heap re-select and
scatter (`tracker_reselect`).  The port's own spans of those names
(`obs/trace.py`; with the tracer on each closes at a synchronize, so it
covers its device work) over the slice run with the tracer on, summed
and divided by the slice's epochs.  It should move
`ingest_events_per_s`.
"""

SPANS = ("tracker_candidates", "tracker_reselect")


def read(ctx):
    spans = [d for s in SPANS for d in ctx["spans"].get(s, ())]
    return None if not spans else 1e3 * sum(spans) / ctx["units"]
