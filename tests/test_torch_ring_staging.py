"""The port's ring staging (`_DeviceRing.append`) against the JAX package.

A sequence of appends goes through the port's `CountService` on the CPU:
batches that grow the staging slots, narrower ones that reuse them, then
single-tenant `enqueue`s at odd fills.  After every call the ring and
the fill mirror must equal what the JAX package's `queue_append_pallas`
/ `queue_append_dense_pallas` (interpret mode) land from the same numpy
inputs, exactly: ring cells are integers.  On the CPU the staging packs
into plain host slots that the append reads in place; on a GPU the same
packing fills pinned slots that are copied without a synchronize
(`tests/test_torch_cuda.py::test_enqueue_many_does_not_synchronize`).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sketch as jks
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sketch as tks
from repro_torch.stream import CountService, WindowSpec

CAPACITY = 2048
NAMES = ("t0", "t1", "t2")


class _JaxRing:
    """The JAX package's ring appends on numpy inputs: the whole-plane
    kernel when the rows are 0..T-1, the row-mapped one otherwise, each
    batch staged CHUNK-quantized as the reference's `_DeviceRing` does."""

    def __init__(self, t: int, capw: int):
        self.queue = np.zeros((t, capw), np.uint32)
        self.fill = np.zeros(t, np.int64)

    def append(self, rows, batches) -> None:
        rows = np.asarray(rows, np.int32)
        n = max(b.size for b in batches)
        keys = np.zeros((len(rows), tks.CHUNK * -(-n // tks.CHUNK)),
                        np.uint32)
        count = np.asarray([b.size for b in batches], np.int32)
        for i, b in enumerate(batches):
            keys[i, :b.size] = b
        fill = self.fill[rows].astype(np.int32)
        if np.array_equal(rows, np.arange(self.queue.shape[0])):
            out = jks.queue_append_dense_pallas(
                jnp.asarray(self.queue), jnp.asarray(keys),
                jnp.asarray(np.stack([fill, count])), interpret=True)
        else:
            out = jks.queue_append_pallas(
                jnp.asarray(self.queue), jnp.asarray(keys),
                jnp.asarray(np.stack([rows, fill, count])), interpret=True)
        self.queue = np.asarray(out)
        self.fill[rows] += count


def _service(windowed: bool) -> CountService:
    spec = tsk.SketchSpec(width=1024, depth=2, counter=tc.CMS32)
    if not windowed:
        return CountService(spec, tenants=NAMES, queue_capacity=CAPACITY,
                            device="cpu")
    svc = CountService(queue_capacity=CAPACITY, device="cpu")
    wspec = WindowSpec(sketch=spec, buckets=4, interval=60.0)
    for name in NAMES:
        svc.add_tenant(name, window=wspec)
    return svc


def _keys(rng, n: int) -> np.ndarray:
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("windowed", [False, True])
def test_staged_appends_equal_jax_ring(windowed):
    """Grow, reuse, then odd-fill single-tenant appends: the port's ring
    and fill equal the JAX package's after every call, and the narrower
    appends reuse the staging slots the wide ones grew."""
    rng = np.random.default_rng(21)
    svc = _service(windowed)
    plane = svc.planes[0]
    ring = plane.ring
    ref = _JaxRing(len(NAMES), ring.queue.shape[1])
    ts = {"ts": 600.0} if windowed else {}  # one interval: no rotation
    row = {n: i for i, n in enumerate(NAMES)}
    steps = [
        ("many", {"t0": 1500, "t1": 700, "t2": 3}),    # dense, grows slot 0
        ("many", {"t2": 1025, "t0": 100, "t1": 1000}),  # all rows, permuted
        ("many", {"t2": 5, "t0": 9}),                   # reuses slot 0
        ("many", {"t1": 17}),                           # reuses slot 1
        ("one", ("t1", 7)),                             # odd fill 1717
        ("one", ("t0", 1)),                             # odd fill 1609
        ("one", ("t2", 3)),
    ]
    grown = None
    for i, (kind, arg) in enumerate(steps):
        if kind == "many":
            events = {n: _keys(rng, k) for n, k in arg.items()}
            svc.enqueue_many(events, **ts)
            ref.append([row[n] for n in events], list(events.values()))
        else:
            name, k = arg
            keys = _keys(rng, k)
            svc.enqueue(name, keys, **ts)
            ref.append([row[name]], [keys])
        assert np.array_equal(ring.fill, ref.fill), f"step {i}"
        assert np.array_equal(tc.to_numpy(ring.queue), ref.queue), \
            f"step {i}"
        if i == 1:  # the two wide appends grew one slot each
            assert all(h.numel() == 3 * 2048 for h in ring._host)
            grown = [h.data_ptr() for h in ring._host]
    assert [h.data_ptr() for h in ring._host] == grown
    assert not any(h.is_pinned() for h in ring._host)  # CPU: plain slots
    assert svc.stats["flushes"] == 0 and plane.pending() == int(
        ref.fill.sum())


def test_staging_pads_to_chunk_and_reads_no_padding():
    """The staged batch is (R, n_pad), n_pad CHUNK-quantized; stale keys
    left in the padding by an earlier, wider append never reach the
    ring."""
    svc = _service(False)
    ring = svc.planes[0].ring
    svc.enqueue_many({"t0": np.full(1500, 7, np.uint32),
                      "t1": np.full(1500, 8, np.uint32),
                      "t2": np.full(1500, 9, np.uint32)})
    svc.enqueue_many({"t0": np.full(2, 1, np.uint32)})
    svc.enqueue_many({"t1": np.full(3, 2, np.uint32)})  # slot 0 again
    staged = ring._stage([np.arange(5, dtype=np.uint32)])
    assert tuple(staged.shape) == (1, tks.CHUNK)
    assert staged.dtype == torch.uint32 and staged.is_contiguous()
    q = tc.to_numpy(ring.queue)
    assert (q[0, :1500] == 7).all() and (q[0, 1500:1502] == 1).all()
    assert (q[1, :1500] == 8).all() and (q[1, 1500:1503] == 2).all()
    assert (q[:, 1503:] == 0).all() and (q[0, 1502] == 0)
    assert ring.fill.tolist() == [1502, 1503, 1500]


@pytest.mark.parametrize("fill,count,n", [
    ([0, 0, -1], [1, 1, 1], 8),      # negative fill
    ([0, 0, 0], [1, -2, 1], 8),      # negative count
    ([0, 0, 0], [1, 9, 1], 8),       # count past the batch width
    ([0, 250, 0], [1, 7, 1], 8),     # fill + count past capw
    ([0, 0], [1, 1], 8),             # one entry short
])
def test_queue_append_dense_rejects_contract_violations(fill, count, n):
    queue = tc.from_numpy(np.zeros((3, 256), np.uint32), "cpu")
    keys = tc.from_numpy(np.zeros((3, n), np.uint32), "cpu")
    with pytest.raises(ValueError):
        tks.queue_append_dense(queue, keys, fill, count)


def test_append_row_cap_matches_the_cuda_source():
    """The wrappers' MAX_APPEND_ROWS mirrors CML_APPEND_MAX_ROWS, the rows
    one append launch carries by value."""
    src = (pathlib.Path(tks.__file__).parent / "csrc" / "common.cuh"
           ).read_text()
    cap = re.search(r"#define CML_APPEND_MAX_ROWS (\d+)", src)
    assert cap and int(cap.group(1)) == tks.MAX_APPEND_ROWS
    depth = re.search(r"#define CML_MAX_DEPTH (\d+)", src)
    assert depth and int(depth.group(1)) == tks.MAX_DEPTH


def test_ops_queue_append_passes_device_keys_through():
    """`ops.queue_append` hands keys that already lie on the ring's device
    to the kernel wrapper as they are (no copy)."""
    queue = tops.queue_init(2, 256, "cpu")
    keys = tc.from_numpy(np.arange(8, dtype=np.uint32).reshape(2, 4), "cpu")
    seen = []
    real = tks.queue_append_dense
    try:
        tks.queue_append_dense = lambda q, k, f, c: seen.append(k) or real(
            q, k, f, c)
        tops.queue_append(queue, keys, [0, 1], [0, 3], [4, 2])
    finally:
        tks.queue_append_dense = real
    assert seen[0].data_ptr() == keys.data_ptr()
    q = tc.to_numpy(queue)
    assert q[0, :4].tolist() == [0, 1, 2, 3] and q[1, 3:5].tolist() == [4, 5]
