"""Milliseconds an epoch that the device sat idle while the program was in one of its own phases (tracked ingest cell).

Layer: API and host control (`stream/service.py` and what it calls).
The profiled slice (the tracer off) labels each idle gap between the
device's operations by the innermost host operation open at its middle
(`breakdown.idle_gaps`, the ten largest labels).  The gaps labelled by
one of the program's `cml.<span>` profiler ranges
(`repro_torch/obs/trace.py`) are those where the host was in the
program's own code and in no torch operation; they are summed and
divided by the slice's epochs.  A gap inside a torch operation the
program called, or under a label below the ten largest, is not counted,
so the reading is a floor.  It should move `ingest_events_per_s`.
"""

PREFIX = "cml."


def read(ctx):
    gaps = [s for label, s in ctx["profile"]["idle_gaps"]
            if label.startswith(PREFIX)]
    return 1e3 * sum(gaps) / ctx["units"] if gaps else None
