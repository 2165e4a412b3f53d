"""Synthetic recsys event streams (Criteo-like click logs, item sequences).

The port's own copy of `repro/data/recsys_stream.py` (numpy only): on the
same numpy it gives the same arrays bit for bit.

Zipf-distributed ids per categorical field (the skew is what makes sketch
admission meaningful), logistic ground-truth labels so training losses are
learnable, and deterministic counter-based sampling (restart-safe, matches
pipeline.BatchSource contract).
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        (seed * 0x9E3779B9 + step * 0x85EBCA6B + shard * 0xC2B2AE35) % (1 << 63))


def _zipf_ids(rng, size, vocab: int, a: float = 1.2) -> np.ndarray:
    raw = rng.zipf(a, size=size)
    return (raw % vocab).astype(np.int32)


def dlrm_batch(step: int, shard: int, n_shards: int, *, global_batch: int,
               table_sizes: list[int], n_dense: int = 13, seed: int = 0) -> dict:
    """One DLRM (Criteo-style) batch shard: dense, sparse ids, labels."""
    b = global_batch // n_shards
    rng = _rng(seed, step, shard)
    dense = rng.lognormal(0.0, 1.0, size=(b, n_dense)).astype(np.float32)
    sparse = np.stack([_zipf_ids(rng, b, v) for v in table_sizes], axis=1)
    # logistic ground truth over a fixed random projection -> learnable labels
    w = np.random.default_rng(seed + 7).normal(size=(n_dense,)).astype(np.float32)
    logits = dense @ w * 0.2 + 0.05 * (sparse[:, 0] % 7 - 3)
    labels = (rng.random(b) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return {"dense": dense, "sparse": sparse.astype(np.int32), "label": labels}


def seq_batch(step: int, shard: int, n_shards: int, *, global_batch: int,
              n_items: int, seq_len: int, seed: int = 0) -> dict:
    """Item-sequence batch for SASRec/BERT4Rec (next-item ground truth)."""
    b = global_batch // n_shards
    rng = _rng(seed, step, shard)
    # sessions drift through a Zipf catalogue with local coherence
    base = _zipf_ids(rng, (b, 1), n_items)
    walk = _zipf_ids(rng, (b, seq_len + 1), max(n_items // 64, 2))
    seqs = ((base + np.cumsum(walk, axis=1)) % n_items).astype(np.int32)
    return {"history": seqs[:, :-1], "target": seqs[:, -1]}


def twotower_batch(step: int, shard: int, n_shards: int, *, global_batch: int,
                   n_users: int, n_items: int, n_user_feats: int = 8,
                   n_item_feats: int = 8, seed: int = 0) -> dict:
    """(user-bag, positive-item-bag) pairs for in-batch sampled softmax."""
    b = global_batch // n_shards
    rng = _rng(seed, step, shard)
    user = _zipf_ids(rng, (b, n_user_feats), n_users)
    item = _zipf_ids(rng, (b, n_item_feats), n_items)
    return {"user_feats": user, "item_feats": item,
            "item_id": item[:, 0].astype(np.int32)}
