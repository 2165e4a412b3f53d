"""Share of its roofline that the read's query entry reaches.

Layer: kernels (`kernels/sketch.py`, `kernels/csrc/`).  The least time
the chip could take for the probes handed to every `ops.query_many` call
of the profiled slice (`harness/work.py`: probes read once, each
distinct (tenant, row, sector) read once, the answers written once,
against the H100's data-sheet bandwidth at 700 W), over the device time
of every kernel launched inside those calls, in %.  It should move
`read_p95_ms`.
"""

ENTRY = "query_many"


def read(ctx):
    least = ctx["least_s"].get(ENTRY)
    spent = ctx["profile"]["ranges"].get(ENTRY, {}).get("device_s", 0.0)
    if least is None or spent <= 0:
        return None
    return 100.0 * least / spent
