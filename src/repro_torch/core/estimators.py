"""Corpus statistics computed from sketch estimates (paper §1, eqs. 1-2),
PyTorch.

Counterpart of `repro/core/estimators.py`.  Every statistic takes a log
of the counts, which is the paper's motivation for log-domain counters:
only the order of magnitude of low-frequency counts matters, so the
multiplicative noise of a Morris counter is benign while the additive
collision noise of a linear CMS is not.  All float32; scalar arguments
(totals, document counts) round to float32 as the reference's do.
"""
from __future__ import annotations

import torch

from repro_torch.core import sketch as sk
from repro_torch.core.counters import f32_const
from repro_torch.core.hashing import combine2

_EPS = 1e-12


def _log_ratio(p_ij: torch.Tensor, p_i: torch.Tensor, p_j: torch.Tensor
               ) -> torch.Tensor:
    eps = f32_const(_EPS, p_ij.device)
    return torch.log(torch.maximum(p_ij, eps) / torch.maximum(p_i * p_j, eps))


def pmi(unigram_sketch: sk.Sketch, bigram_sketch: sk.Sketch,
        left: torch.Tensor, right: torch.Tensor,
        total_unigrams: float, total_bigrams: float) -> torch.Tensor:
    """Pointwise mutual information of word pairs (paper eq. 2):
    log(p(i,j) / (p(i) p(j))), p(i,j) = c_ij / T_bi, p(i) = c_i / T_uni,
    every count estimated from the sketches."""
    c_i = sk.query(unigram_sketch, left)
    c_j = sk.query(unigram_sketch, right)
    c_ij = sk.query(bigram_sketch, combine2(left, right))
    return pmi_exact(c_i, c_j, c_ij, total_unigrams, total_bigrams)


def pmi_exact(c_i: torch.Tensor, c_j: torch.Tensor, c_ij: torch.Tensor,
              total_unigrams: float, total_bigrams: float) -> torch.Tensor:
    """PMI from given (exact) counts, for the Fig. 2/3 comparisons."""
    dev = c_ij.device
    t_bi = f32_const(total_bigrams, dev)
    t_uni = f32_const(total_unigrams, dev)
    return _log_ratio(c_ij / t_bi, c_i / t_uni, c_j / t_uni)


def idf(doc_freq_sketch: sk.Sketch, terms: torch.Tensor, n_docs: float
        ) -> torch.Tensor:
    """Inverse document frequency (paper eq. 1a) from a doc-frequency
    sketch: log(n_docs / max(df, 1))."""
    df = sk.query(doc_freq_sketch, terms)
    return torch.log(f32_const(n_docs, df.device)
                     / torch.clamp_min(df, 1.0))


def tfidf(tf: torch.Tensor, doc_freq_sketch: sk.Sketch,
          terms: torch.Tensor, n_docs: float) -> torch.Tensor:
    """tf-idf (paper eq. 1b): the caller supplies per-document tf."""
    return tf * idf(doc_freq_sketch, terms, n_docs)


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    eps = f32_const(_EPS, x.device)
    return torch.where(x > 0, x * torch.log(torch.maximum(x, eps)),
                       torch.zeros_like(x))


def log_likelihood_ratio(k11, k12, k21, k22) -> torch.Tensor:
    """Dunning's LLR for a 2x2 contingency table of (estimated) counts."""
    row1, row2 = k11 + k12, k21 + k22
    col1, col2 = k11 + k21, k12 + k22
    total = row1 + row2
    h_all = _xlogx(k11) + _xlogx(k12) + _xlogx(k21) + _xlogx(k22)
    h_row = _xlogx(row1) + _xlogx(row2)
    h_col = _xlogx(col1) + _xlogx(col2)
    return 2.0 * (h_all + _xlogx(total) - h_row - h_col)


def llr_bigram(unigram_sketch: sk.Sketch, bigram_sketch: sk.Sketch,
               left: torch.Tensor, right: torch.Tensor,
               total_bigrams: float) -> torch.Tensor:
    """LLR association score of bigrams from sketch estimates."""
    c_ij = sk.query(bigram_sketch, combine2(left, right))
    c_i = sk.query(unigram_sketch, left)
    c_j = sk.query(unigram_sketch, right)
    k12 = torch.clamp_min(c_i - c_ij, 0.0)
    k21 = torch.clamp_min(c_j - c_ij, 0.0)
    k22 = torch.clamp_min(
        f32_const(total_bigrams, c_ij.device) - c_i - c_j + c_ij, 0.0)
    return log_likelihood_ratio(c_ij, k12, k21, k22)
