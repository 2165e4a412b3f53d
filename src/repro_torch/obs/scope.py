"""The scope of one public call: its dispatch tally, its counts, its tracer.

Code below the service holds no registry and no tracer.  It reports to
the scopes that are active while it runs:

  * `kernels/ops.py` tallies one dispatch an op (`dispatch`);
  * `core/staging.py` counts the bytes it packs for the device, its
    uploads and its waits on a slot (`count`);
  * a span opened below the service (`obs.trace.span`) opens on the
    tracer of the innermost scope that has one (`tracer`).

`CountService` activates one scope around each public call and folds
its tallies into the service's registry when the call ends
(`dispatch{op=...}` and the named counters).  Every dispatch also lands
in the process-wide default scope (`kernels.ops.launch_counts`); a count
lands only in the scopes a call activated.  Host-side integers only:
nothing here touches the device.
"""
from __future__ import annotations

import collections


class Scope:
    """Tallies of one with-block: `dispatches` {op: n}, `counts`
    {counter name: n}, and the tracer spans below the service open on
    (None: none)."""

    __slots__ = ("dispatches", "counts", "tracer")

    def __init__(self, tracer=None):
        self.dispatches: collections.Counter = collections.Counter()
        self.counts: collections.Counter = collections.Counter()
        self.tracer = tracer


DEFAULT = Scope()
_ACTIVE: list[Scope] = [DEFAULT]


def dispatch(op: str) -> None:
    for s in _ACTIVE:
        s.dispatches[op] += 1


def count(name: str, n: int = 1) -> None:
    for s in _ACTIVE[1:]:  # not DEFAULT: nothing reads its counts
        s.counts[name] += n


def tracer():
    """The tracer of the innermost active scope that has one, or None."""
    for s in reversed(_ACTIVE):
        if s.tracer is not None:
            return s.tracer
    return None


class active:
    """Context manager making `scope` active for one with-block; yields
    it."""

    def __init__(self, scope: Scope):
        self.scope = scope

    def __enter__(self) -> Scope:
        _ACTIVE.append(self.scope)
        return self.scope

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self.scope)  # a Scope equals only itself
