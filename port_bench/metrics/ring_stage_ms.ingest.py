"""Milliseconds an epoch of the ingest ring's host staging (tracked ingest cell).

Layer: host staging (`stream/service.py` `_DeviceRing._stage`,
`core/staging.py`): packing each append's microbatches into a pinned
slot and issuing its `non_blocking` copy.  The port's own
`ring_stage` spans (`obs/trace.py`; they synchronize nothing, so they
cover the host's work) over the slice run with the tracer on, divided
by the slice's epochs.  It should move `ingest_events_per_s`.
"""


def read(ctx):
    spans = ctx["spans"].get("ring_stage")
    return None if not spans else 1e3 * sum(spans) / ctx["units"]
