"""Share of its roofline that the windowed flush's update entry reaches.

Layer: kernels (`kernels/sketch.py`, `kernels/csrc/`).  The least time
the chip could take for the inputs handed to every
`ops.update_rows` call of the profiled slice (`harness/work.py`:
live keys read once, each distinct sector of the active buckets read and
written, each key's uniform drawn, against the H100's data-sheet
bandwidth and float32 rate at 700 W), over the device time of every kernel
launched inside those calls, in %.  It should move
`window_ingest_events_per_s`.
"""

ENTRY = "update_rows"


def read(ctx):
    least = ctx["least_s"].get(ENTRY)
    spent = ctx["profile"]["ranges"].get(ENTRY, {}).get("device_s", 0.0)
    if least is None or spent <= 0:
        return None
    return 100.0 * least / spent
