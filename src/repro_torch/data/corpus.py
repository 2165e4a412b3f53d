"""Synthetic Zipfian corpus calibrated to the paper's 20newsgroups slice.

Counterpart of `repro/data/corpus.py` (numpy only, the same draws from
the same seed, so the same tokens).  The paper counts unigrams and
bigrams over 500k words: 233k distinct elements (50k unigrams + 183k
bigrams).  The stream is a Zipf-Mandelbrot token draw whose exponent and
phrase-copy rate are calibrated so that 500k tokens give the same
distinct-count profile; the CMS / CMLS comparison depends only on the
skew of the counts, not on word identity.  Generated here, nothing is
downloaded.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    n_tokens: int = 500_000
    vocab_size: int = 120_000
    zipf_s: float = 0.7291    # calibrated: 49,952 distinct unigrams @ 500k tokens
    zipf_q: float = 2.7       # Mandelbrot shift (flattens the head like real text)
    p_copy: float = 0.4293    # calibrated: 182,998 distinct bigrams @ 500k tokens
    copy_len: int = 4         # mean copied-phrase length (geometric)
    doc_len: int = 300        # tokens per document (for TF-IDF statistics)
    seed: int = 20150218      # paper date


def token_probs(spec: CorpusSpec) -> np.ndarray:
    ranks = np.arange(1, spec.vocab_size + 1, dtype=np.float64)
    p = 1.0 / (ranks + spec.zipf_q) ** spec.zipf_s
    return p / p.sum()


def generate(spec: CorpusSpec) -> np.ndarray:
    """Sample the token stream; ids are frequency-ranked (0 = most common).

    Real text is Markovian (phrases repeat): with probability p_copy a
    geometric-length phrase is copied from earlier in the stream,
    otherwise a fresh Zipf token is emitted.  Copied phrases are Zipf
    distributed themselves, so the unigram marginals hold.
    """
    rng = np.random.default_rng(spec.seed)
    fresh = rng.choice(spec.vocab_size, size=spec.n_tokens,
                       p=token_probs(spec)).astype(np.uint32)
    if spec.p_copy <= 0:
        return fresh
    out = np.empty(spec.n_tokens + 64, dtype=np.uint32)
    out[:256] = fresh[:256]
    pos, fresh_pos = 256, 256
    while pos < spec.n_tokens:
        if rng.random() < spec.p_copy:
            ln = 2 + rng.geometric(1.0 / max(spec.copy_len - 1, 1))
            start = rng.integers(0, pos - ln) if pos > ln else 0
            ln = min(ln, spec.n_tokens + 64 - pos)
            out[pos:pos + ln] = out[start:start + ln]
            pos += ln
        else:
            out[pos] = fresh[fresh_pos % spec.n_tokens]
            fresh_pos += 1
            pos += 1
    return out[:spec.n_tokens]


def profile(tokens: np.ndarray) -> dict:
    """Distinct-count profile to compare against the paper's corpus."""
    uni = np.unique(tokens).size
    big = np.unique(tokens[:-1].astype(np.uint64) << np.uint64(32)
                    | tokens[1:].astype(np.uint64)).size
    return {
        "n_tokens": int(tokens.size),
        "distinct_unigrams": int(uni),
        "distinct_bigrams": int(big),
        "distinct_total": int(uni + big),
        "paper_reference": {"distinct_unigrams": 50_000,
                            "distinct_bigrams": 183_000,
                            "distinct_total": 233_000},
    }


def documents(tokens: np.ndarray, spec: CorpusSpec):
    """Iterate fixed-length documents of `spec.doc_len` tokens (TF-IDF and
    per-document statistics); a short tail is dropped."""
    for i in range(0, len(tokens) - spec.doc_len + 1, spec.doc_len):
        yield tokens[i:i + spec.doc_len]


def calibrate(n_tokens: int = 500_000, target_unigrams: int = 50_000,
              target_bigrams: int = 183_000, iters: int = 10) -> CorpusSpec:
    """Nested bisection of (zipf_s, p_copy) to hit the paper's profile:
    for each p_copy, bisect zipf_s until the distinct unigrams reach
    `target_unigrams`, then move p_copy by the distinct bigrams.  Fixed
    `CorpusSpec`'s defaults once; kept for reproducibility."""
    p_lo, p_hi = 0.0, 0.7
    best = CorpusSpec()
    for _ in range(iters):
        p = 0.5 * (p_lo + p_hi)
        s_lo, s_hi = 0.3, 1.6
        for _ in range(iters):
            s = 0.5 * (s_lo + s_hi)
            spec = CorpusSpec(n_tokens=n_tokens, zipf_s=s, p_copy=p)
            if np.unique(generate(spec)).size > target_unigrams:
                s_lo = s  # more skew, fewer distinct
            else:
                s_hi = s
        spec = CorpusSpec(n_tokens=n_tokens, zipf_s=0.5 * (s_lo + s_hi),
                          p_copy=p)
        if profile(generate(spec))["distinct_bigrams"] > target_bigrams:
            p_lo = p  # more copying, fewer distinct
        else:
            p_hi = p
        best = spec
    return best
