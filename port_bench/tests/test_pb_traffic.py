"""The traffic pool: the same for the same seed, different for another,
every seed the same sizes, and the corpus model's calibration kept."""
import numpy as np
import pytest
import torch

from conftest import MIXES, tiny
from harness import traffic as tr

CORPUS = tiny("ngram-tracked-ingest").traffic["corpus"]


def _pool(cell, seed):
    c = tiny(cell)
    return tr.make_pool(c.traffic, c.config["tenants"], seed, "cpu")


@pytest.mark.parametrize("cell", MIXES)
def test_same_seed_same_pool(cell):
    a, b = _pool(cell, 2**31 + 12345), _pool(cell, 2**31 + 12345)
    for x, y in zip((a.keys, a.metrics, a.gaps, a.probes),
                    (b.keys, b.metrics, b.gaps, b.probes)):
        assert (x is None and y is None) or np.array_equal(x, y)


@pytest.mark.parametrize("cell", MIXES)
def test_other_seed_other_pool_same_sizes(cell):
    a, b = _pool(cell, 1), _pool(cell, 2)
    assert a.keys.shape == b.keys.shape and not np.array_equal(a.keys, b.keys)
    if a.gaps is not None:   # the same event times for every seed
        assert np.array_equal(a.gaps, b.gaps)
        assert abs(a.gaps.mean() - 25.0) < 0.5


def test_vectorised_corpus_keeps_the_papers_profile():
    """500k tokens give about 50k distinct unigrams and 183k distinct
    bigrams, as the calibrated loop does."""
    tok = tr.tokens(torch.Generator().manual_seed(3), 1, 500_000, CORPUS,
                    "cpu")[0].numpy()
    uni = np.unique(tok).size
    big = np.unique(tok[:-1] * 2**20 + tok[1:]).size
    assert abs(uni - 50_000) < 1_500 and abs(big - 183_000) < 4_000


def test_events_interleave_unigram_and_bigram_keys():
    tok = torch.tensor([[5, 9, 5, 9, 7]])
    ev = tr.events(tok, 6)[0]
    assert ev[0] == 5 and ev[2] == 9 and ev[1] == ev[5] \
        and ev[1] == tr.combine2(torch.tensor(5), torch.tensor(9))


def test_plan_replays_the_pool_and_counts_events():
    c = tiny("ngram-window-ingest")
    pool = tr.make_pool(c.traffic, 3, 9, "cpu")
    plan = tr.Plan(c.traffic, pool, ["a", "b", "c"], "metrics_qps")
    u0, u2 = plan.microbatches(0), plan.microbatches(c.traffic["pool_units"])
    assert all(np.array_equal(x[0]["a"], y[0]["a"]) for x, y in zip(u0, u2))
    ts = [t for _, _, t in u0] + [t for _, _, t in plan.microbatches(1)]
    assert all(b > a for a, b in zip(ts, ts[1:]))
    per = c.traffic["events_per_tenant"]
    assert plan.events_in() == c.traffic["microbatches"] * (
        3 * per + c.traffic["metrics_events"])
