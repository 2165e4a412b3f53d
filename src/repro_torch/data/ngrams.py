"""N-gram event streams and exact reference counts (paper §3 workload).

Counterpart of `repro/data/ngrams.py`, numpy only.  Bigram keys use the
same combine as `repro_torch.core.hashing.combine2`, so a bigram counted
here is the key a sketch probe of (left, right) hashes.
"""
from __future__ import annotations

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer (`hashing.mix32`)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EB_CA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2_AE35)
    x ^= x >> np.uint32(16)
    return x


def bigram_keys_np(tokens: np.ndarray) -> np.ndarray:
    """uint32 key of every bigram occurrence: combine2(left, right)."""
    a = tokens[:-1].astype(np.uint32)
    b = tokens[1:].astype(np.uint32)
    with np.errstate(over="ignore"):
        return _mix(a * np.uint32(0x9E37_79B1)
                    + _mix(b ^ np.uint32(0x85EB_CA6B)))


def unigram_keys_np(tokens: np.ndarray, vocab_size: int) -> np.ndarray:
    """uint32 key of every unigram occurrence: its token id (below 2^20,
    far from the mixed bigram keys), so both kinds share one sketch as
    the paper counts them.  `vocab_size` is accepted and unused, as in
    the reference."""
    del vocab_size
    return tokens.astype(np.uint32)


def event_stream(tokens: np.ndarray) -> np.ndarray:
    """The paper's update stream: every unigram occurrence then every
    bigram occurrence, in one sketch as the paper counts both kinds in
    one structure."""
    return np.concatenate([unigram_keys_np(tokens, 0),
                           bigram_keys_np(tokens)])


def exact_counts(keys: np.ndarray):
    """(unique_keys, counts): the perfect-storage reference."""
    return np.unique(keys, return_counts=True)


def perfect_storage_bytes(n_distinct: int, bytes_per_entry: int = 4) -> int:
    """The paper's ideal perfect count storage: one 4-byte counter per
    distinct element (keys and access structures not counted)."""
    return n_distinct * bytes_per_entry


def bigram_pairs(tokens: np.ndarray):
    """(left, right) unigram ids of every bigram occurrence (for PMI)."""
    return tokens[:-1].astype(np.uint32), tokens[1:].astype(np.uint32)
