"""Kernel launches a read cycle of the scoring-read cell.

Layer: API and host control (`stream/service.py`).  The host side of
the profiled slice's trace counts `cudaLaunchKernel` calls (and the
driver API's launches) over the slice's read cycles (the trickle's
append, the read-your-writes flush, `query_all` and the copy of the
answers), divided by the reads.  It should move `read_p95_ms`.
"""


def read(ctx):
    n = ctx["profile"]["launches"]
    return n / ctx["units"] if n else None
