"""Sharded, prefetching, restart-deterministic data pipeline.

The port's own copy of `repro/data/pipeline.py` (numpy and threading
only): the same batches bit for bit on the same numpy.

Design constraints for the 1000-node target:
  * every host computes its own shard of every global batch from the step
    index alone (stateless indexing) — restart at step k needs no replay
    and no coordination, only the step counter from the checkpoint;
  * prefetch runs in a background thread with a bounded queue so host-side
    generation overlaps device compute (straggler mitigation: a host that
    falls behind burns its queue slack before it delays anyone);
  * all randomness is counter-based (seed = f(global_seed, step, host)) so
    elastically re-sharding hosts N -> M re-partitions the same stream.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class BatchSource:
    """Stateless batch generator: (step, shard, n_shards) -> host batch."""

    def __init__(self, fn: Callable[[int, int, int], dict], seed: int = 0):
        self.fn = fn
        self.seed = seed

    def batch(self, step: int, shard: int, n_shards: int) -> dict:
        return self.fn(step, shard, n_shards)


def token_batch_source(tokens: np.ndarray, global_batch: int, seq_len: int,
                       seed: int = 0) -> BatchSource:
    """LM batches cut deterministically from a token stream.

    Window origin is a counter-based hash of (seed, step, row) so any
    (shard, n_shards) factorization sees the same global batch.
    """
    n = len(tokens) - seq_len - 1

    def fn(step: int, shard: int, n_shards: int) -> dict:
        rows_per_shard = global_batch // n_shards
        row0 = shard * rows_per_shard
        rows = np.arange(row0, row0 + rows_per_shard, dtype=np.uint64)
        with np.errstate(over="ignore"):
            mix = (np.uint64(seed & 0xFFFF_FFFF) * np.uint64(0x9E3779B97F4A7C15)
                   + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
                   + rows * np.uint64(0x94D049BB133111EB))
            mix ^= mix >> np.uint64(31)
        starts = (mix % np.uint64(n)).astype(np.int64)
        idx = starts[:, None] + np.arange(seq_len + 1)[None, :]
        window = tokens[idx]
        return {"tokens": window[:, :-1].astype(np.int32),
                "targets": window[:, 1:].astype(np.int32)}

    return BatchSource(fn, seed)


class Prefetcher:
    """Bounded-queue background prefetch over a BatchSource."""

    def __init__(self, source: BatchSource, shard: int, n_shards: int,
                 start_step: int = 0, depth: int = 4):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(start_step, shard, n_shards), daemon=True)
        self._thread.start()

    def _run(self, step: int, shard: int, n_shards: int):
        while not self._stop.is_set():
            batch = self.source.batch(step, shard, n_shards)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
