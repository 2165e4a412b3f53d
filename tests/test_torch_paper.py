"""The port's paper path against the JAX package's (CPU).

  * `topk.init` / `topk.refresh` (the single-sketch tracker) beside
    `repro.core.topk`, the cases of `tests/test_topk.py` (ranking,
    eviction and re-entry, dedup in a batch, key 0xFFFFFFFF, empty slots
    over a genuine key 0) and a crowded CMLS16 sketch;
  * `data/corpus` (`documents`, `calibrate` at a small size too) and
    `data/ngrams` (`unigram_keys_np` too): the same tokens for the default
    `CorpusSpec` and a 20,000-token one, the same keys, pairs and exact
    counts, and `bigram_keys_np` equal to `hashing.combine2`;
  * `configs`: `PaperSketchConfig.spec` equal in width, depth and counter
    for every variant, budget and packing, and the registry;
  * the three examples: `main(--device cpu)` at a small size beside the
    reference example at the same seed (streaming PMI and trending items
    run as subprocesses with their size flags; the quickstart, which has
    none, composed in-process from the reference's own calls).

Tolerances: none for the sketches' work.  The tracker's keys, order,
occupancy and estimates, the corpus, keys, counts, configs, the sketches
the examples count (cell for cell), their estimates (bit for bit: the
port computes the reference's float32 graphs, `core/xla_f32.py`), the
ARE and the trending rankings are equal.  The PMI example's scores go
through `core/estimators.py`'s float32 `log`, which is torch's, not
XLA's: its RMSE is held to the last printed digit and its ranking equal
up to ulp-level ties (at every rank the reference's pick scores within
8 ulp of the port's; equal picks where the scores are apart).
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_sketch as jpaper
from repro.configs import registry as jreg
from repro.core import CMLS16 as JCMLS16
from repro.core import CMS32 as JCMS32
from repro.core import SketchSpec as JSpec
from repro.core import sketch as jsk
from repro.core import topk as jtk
from repro.core.hashing import combine2 as jcombine2
from repro.data import corpus as jcorpus
from repro.data import ngrams as jngrams
from repro_torch.configs import paper_sketch as tpaper
from repro_torch.configs import registry as treg
from repro_torch.core import CMLS16, CMS32, SketchSpec
from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.core import topk as ttk
from repro_torch.core.hashing import combine2 as tcombine2
from repro_torch.data import corpus as tcorpus
from repro_torch.data import ngrams as tngrams

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import quickstart_torch  # noqa: E402
import streaming_pmi_torch  # noqa: E402
import trending_items_torch  # noqa: E402

BIG = 0xFFFF_FFFF


def _t(a):
    return tc.from_numpy(np.asarray(a), "cpu")


# --------------------------------------------------------------------------
# topk.init / topk.refresh
# --------------------------------------------------------------------------

class _Pair:
    """One reference sketch and one port sketch fed the same updates."""

    def __init__(self, width=1 << 14, depth=4, jcounter=JCMS32,
                 tcounter=CMS32):
        self.js = jsk.init(JSpec(width=width, depth=depth, counter=jcounter))
        self.ts = tsk.init(SketchSpec(width=width, depth=depth,
                                      counter=tcounter), device="cpu")

    def update(self, counts: dict, seed: int):
        keys = np.asarray(list(counts), np.uint32)
        w = np.asarray([counts[k] for k in counts], np.float32)
        key = np.array([0, seed], np.uint32)
        self.js = jsk.update_batched(self.js, jnp.asarray(keys),
                                     jax.random.PRNGKey(seed),
                                     weights=jnp.asarray(w))
        self.ts = tsk.update_batched(self.ts, _t(keys), key,
                                     weights=torch.from_numpy(w))


def _refresh(jtr, ttr, pair, batch, valid=None):
    b = np.asarray(batch, np.uint32)
    jtr = jtk.refresh(jtr, pair.js, jnp.asarray(b),
                      None if valid is None else jnp.asarray(valid))
    ttr = ttk.refresh(ttr, pair.ts, _t(b),
                      None if valid is None else torch.from_numpy(valid))
    _same_tracker(ttr, jtr)
    return jtr, ttr


def _same_tracker(ttr, jtr):
    assert ttr.keys.dtype == torch.uint32 and ttr.keys.dim() == 1
    np.testing.assert_array_equal(tc.to_numpy(ttr.keys), np.asarray(jtr.keys))
    np.testing.assert_array_equal(ttr.filled.numpy(), np.asarray(jtr.filled))
    got, want = ttr.estimates.numpy(), np.asarray(jtr.estimates)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_topk_init_is_cold():
    tr = ttk.init(5, device="cpu")
    ref = jtk.init(5)
    assert tuple(tr.keys.shape) == (5,) and tr.keys.dtype == torch.uint32
    _same_tracker(tr, ref)


def test_topk_fills_and_ranks():
    pair = _Pair()
    pair.update({1: 100, 2: 80, 3: 60, 4: 40}, 0)
    jtr, ttr = _refresh(jtk.init(3), ttk.init(3, device="cpu"), pair,
                        [1, 2, 3, 4])
    assert tc.to_numpy(ttr.keys).tolist() == [1, 2, 3]
    np.testing.assert_array_equal(ttr.estimates.numpy(), [100, 80, 60])


def test_topk_refresh_after_eviction():
    """An evicted key re-enters when it turns hot (through the batch), and
    every survivor's estimate is the sketch's current answer."""
    pair = _Pair()
    pair.update({1: 100, 2: 80, 3: 60}, 0)
    jtr, ttr = _refresh(jtk.init(3), ttk.init(3, device="cpu"), pair,
                        [1, 2, 3])
    pair.update({4: 70}, 1)
    jtr, ttr = _refresh(jtr, ttr, pair, [4])
    assert set(tc.to_numpy(ttr.keys).tolist()) == {1, 2, 4}
    pair.update({3: 90}, 2)
    jtr, ttr = _refresh(jtr, ttr, pair, [3, 9])
    est = dict(zip(tc.to_numpy(ttr.keys).tolist(),
                   ttr.estimates.numpy().tolist()))
    assert est == {3: 150.0, 1: 100.0, 2: 80.0}


def test_topk_dedup_within_batch_and_valid_mask():
    pair = _Pair()
    pair.update({5: 50, 6: 40, 7: 45}, 0)
    jtr, ttr = _refresh(jtk.init(4), ttk.init(4, device="cpu"), pair,
                        [5, 5, 5, 6])
    keys = tc.to_numpy(ttr.keys).tolist()
    assert keys.count(5) == 1 and keys.count(6) == 1
    # a masked batch slot never enters, however hot its key
    _refresh(jtr, ttr, pair, [7, 7, 6], np.array([False, False, True]))


def test_topk_tracks_max_uint32_key():
    pair = _Pair()
    pair.update({BIG: 90, 1: 100, 2: 50}, 0)
    jtr, ttr = _refresh(jtk.init(2), ttk.init(2, device="cpu"), pair,
                        [1, BIG, 2])
    assert tc.to_numpy(ttr.keys).tolist() == [1, BIG]
    assert ttr.filled.all()


def test_topk_empty_slots_do_not_shadow_key_zero():
    pair = _Pair()
    pair.update({0: 5}, 0)
    jtr, ttr = _refresh(jtk.init(3), ttk.init(3, device="cpu"), pair, [0])
    assert ttr.filled.tolist() == [True, False, False]
    assert int(tc.to_numpy(ttr.keys)[0]) == 0
    assert float(ttr.estimates[0]) == 5.0
    assert torch.isneginf(ttr.estimates[1:]).all()


def test_topk_refresh_on_a_crowded_log_sketch():
    """A narrow CMLS16 sketch and Zipf batches with ties: the same keys,
    order, occupancy and estimates."""
    pair = _Pair(width=512, depth=2, jcounter=JCMLS16, tcounter=CMLS16)
    rng = np.random.default_rng(3)
    jtr, ttr = jtk.init(16), ttk.init(16, device="cpu")
    for i in range(6):
        batch = (rng.zipf(1.3, 3000) % 2000).astype(np.uint32)
        batch[:2] = [0, BIG]
        key = np.array([0, 40 + i], np.uint32)
        pair.js = jsk.update_batched(pair.js, jnp.asarray(batch),
                                     jax.random.PRNGKey(40 + i))
        pair.ts = tsk.update_batched(pair.ts, _t(batch), key)
        np.testing.assert_array_equal(tc.to_numpy(pair.ts.table),
                                      np.asarray(pair.js.table))
        jtr, ttr = _refresh(jtr, ttr, pair, batch[:500])


# --------------------------------------------------------------------------
# corpus, n-grams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_tokens", [500_000, 20_000])
def test_corpus_matches(n_tokens):
    jspec = jcorpus.CorpusSpec(n_tokens=n_tokens)
    tspec = tcorpus.CorpusSpec(n_tokens=n_tokens)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    np.testing.assert_array_equal(tcorpus.token_probs(tspec),
                                  jcorpus.token_probs(jspec))
    toks = tcorpus.generate(tspec)
    want = jcorpus.generate(jspec)
    assert toks.dtype == np.uint32
    np.testing.assert_array_equal(toks, want)
    assert tcorpus.profile(toks) == jcorpus.profile(want)
    no_copy = tcorpus.CorpusSpec(n_tokens=5000, p_copy=0.0)
    np.testing.assert_array_equal(
        tcorpus.generate(no_copy),
        jcorpus.generate(jcorpus.CorpusSpec(n_tokens=5000, p_copy=0.0)))


@pytest.mark.parametrize("doc_len", [300, 7])
def test_documents_match(doc_len):
    toks = tcorpus.generate(tcorpus.CorpusSpec(n_tokens=20_000))
    got = list(tcorpus.documents(toks, tcorpus.CorpusSpec(doc_len=doc_len)))
    want = list(jcorpus.documents(toks, jcorpus.CorpusSpec(doc_len=doc_len)))
    assert len(got) == len(want) == 20_000 // doc_len
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("targets", [(900, 2000), (1200, 2600)])
def test_calibrate_matches(targets):
    """The nested bisection at 4,000 tokens and 3 steps a level: the same
    spec, field for field."""
    kw = dict(n_tokens=4000, target_unigrams=targets[0],
              target_bigrams=targets[1], iters=3)
    got, want = tcorpus.calibrate(**kw), jcorpus.calibrate(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unigram_keys_match():
    toks = tcorpus.generate(tcorpus.CorpusSpec(n_tokens=20_000))
    got = tngrams.unigram_keys_np(toks, 120_000)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jngrams.unigram_keys_np(toks, 120_000))
    np.testing.assert_array_equal(
        tngrams.unigram_keys_np(toks.astype(np.int64), 0),
        jngrams.unigram_keys_np(toks.astype(np.int64), 0))


def test_ngrams_match():
    toks = tcorpus.generate(tcorpus.CorpusSpec(n_tokens=20_000))
    keys = tngrams.bigram_keys_np(toks)
    np.testing.assert_array_equal(keys, jngrams.bigram_keys_np(toks))
    # the bigram key is the sketch's combine2 of (left, right)
    left, right = tngrams.bigram_pairs(toks)
    jl, jr = jngrams.bigram_pairs(toks)
    np.testing.assert_array_equal(left, jl)
    np.testing.assert_array_equal(right, jr)
    np.testing.assert_array_equal(
        keys, np.asarray(jcombine2(jnp.asarray(left), jnp.asarray(right))))
    np.testing.assert_array_equal(
        keys, tc.to_numpy(tc.from_i64(tcombine2(_t(left), _t(right)),
                                      torch.uint32)))
    ev = tngrams.event_stream(toks)
    np.testing.assert_array_equal(ev, jngrams.event_stream(toks))
    for a, b in zip(tngrams.exact_counts(ev), jngrams.exact_counts(ev)):
        np.testing.assert_array_equal(a, b)
    assert (tngrams.perfect_storage_bytes(233_000)
            == jngrams.perfect_storage_bytes(233_000) == 932_000)
    assert tngrams.perfect_storage_bytes(10, 2) == 20


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_paper_sketch_config_matches():
    tcfg, jcfg = tpaper.CFG, jpaper.CFG
    assert tcfg.depth == jcfg.depth == 2
    assert tcfg.budgets == jcfg.budgets and len(tcfg.budgets) == 8
    assert tcfg.perfect_storage_bytes == jcfg.perfect_storage_bytes
    assert list(tcfg.variants) == list(jcfg.variants)
    for variant in tcfg.variants:
        for budget in tcfg.budgets:
            for packed in (False, True):
                t = tcfg.spec(variant, budget, packed)
                j = jcfg.spec(variant, budget, packed)
                assert (t.width, t.depth, t.packed) == (j.width, j.depth,
                                                        j.packed)
                assert (t.counter.kind, t.counter.base, t.counter.bits) == (
                    j.counter.kind, j.counter.base, j.counter.bits)
                assert t.memory_bytes == j.memory_bytes <= budget


def test_registry():
    arch = treg.get("paper-sketch")
    assert arch is treg.get("paper_sketch") and arch.family == "paper"
    assert arch.cfg is tpaper.CFG and arch.shapes == {}
    # every reference arch
    assert set(treg.load_all()) == set(jreg.load_all())
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get("no-such-arch")
    for name in ("LM_SHAPES", "RECSYS_SHAPES", "GNN_SHAPES"):
        assert getattr(treg, name) == getattr(jreg, name)


# --------------------------------------------------------------------------
# the examples
# --------------------------------------------------------------------------

def _run_reference(script: str, *args) -> list[str]:
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def _lines(capsys) -> list[str]:
    return capsys.readouterr().out.splitlines()


def _ulp_close(a, b, n=8) -> bool:
    a, b = np.float32(a), np.float32(b)
    return bool(abs(a - b) <= n * np.spacing(max(abs(a), abs(b))))


def _same_ranking(port_ids, ref_ids, score):
    """Both rankings pick, rank for rank, scores within 8 ulp under the
    port's `score` (id -> float32): equal up to ulp-level ties (the PMI
    example's, whose log is torch's)."""
    assert len(port_ids) == len(ref_ids)
    for i, (p, r) in enumerate(zip(port_ids, ref_ids)):
        assert p == r or _ulp_close(score(p), score(r)), (i, p, r)


def test_quickstart_matches(capsys):
    """The reference quickstart has no size flag: its calls, composed
    here at 20,000 events (5,000 through the kernels)."""
    from repro.core import CMLS8 as JCMLS8
    from repro.core import query as jquery
    from repro.core import update as jupdate
    from repro.kernels import ops as jops
    n, nk = 20_000, 5_000
    got = quickstart_torch.main(["--events", str(n), "--kernel-events",
                                 str(nk), "--device", "cpu"])
    lines = _lines(capsys)
    rng = np.random.default_rng(0)
    events = jnp.asarray((rng.zipf(1.3, n) % 30_000).astype(np.uint32))
    uniq, true = np.unique(np.asarray(events), return_counts=True)
    assert lines[0] == (f"stream: {n} events, {len(uniq)} distinct keys, "
                        f"64 kB sketch budget")
    for (name, _), jcounter, line in zip(quickstart_torch.FORMATS,
                                         [JCMS32, JCMLS16, JCMLS8],
                                         lines[2:5]):
        spec = JSpec.from_memory(64 * 1024, depth=2, counter=jcounter)
        sketch = jupdate(jsk.init(spec), events, jax.random.PRNGKey(0),
                         mode="batched")
        est = np.asarray(jquery(sketch, jnp.asarray(uniq)))
        are = np.mean(np.abs(est - true) / true)
        assert line == f"{name:24s} width={spec.width:7d}  ARE={are:8.4f}"
        assert got["are"][name] == are
    spec = JSpec.from_memory(64 * 1024, depth=2, counter=JCMLS16)
    sketch = jops.update(jsk.init(spec), events[:nk], jax.random.PRNGKey(1))
    est = jops.query(sketch, jnp.asarray(uniq[:8]))
    assert got["kernel_estimates"] == [round(float(x), 1) for x in est]
    assert got["true"] == true[:8].tolist()


def test_streaming_pmi_matches(capsys):
    args = ["--tokens", "20000", "--budget-kb", "64"]
    want = _run_reference("streaming_pmi.py", *args)
    got = streaming_pmi_torch.main(args + ["--device", "cpu"])
    lines = _lines(capsys)
    assert lines[:3] == want[:3]  # corpus, sketch and the RMSE line
    m = re.search(r"RMSE vs exact counts = ([0-9.]+)", want[2])
    assert got["rmse"] == pytest.approx(float(m.group(1)), abs=5e-5)
    ref_top = [tuple(int(x) for x in re.findall(r"-?\d+", ln)[:2])
               for ln in want[-10:]]
    pmi = dict(zip(got["pairs"], got["pmi_est"]))
    _same_ranking(got["top10"], ref_top, pmi.__getitem__)
    # the printed estimate / truth columns agree rank for rank
    assert [ln[-16:] for ln in lines[-10:]] == [ln[-16:] for ln in want[-10:]]


def test_trending_items_matches(capsys):
    args = ["--rotations", "4", "--per-rotation", "2000"]
    want = _run_reference("trending_items.py", *args)
    got = trending_items_torch.main(args + ["--device", "cpu"])
    lines = _lines(capsys)
    assert len(lines) == len(want)
    table = slice(3, 13)
    for i, name in enumerate(got["ranked"]):
        ref_ids = [int(ln.split()[1 + i]) for ln in want[table]]
        assert got["ranked"][name] == ref_ids, name
    hits = [ln for ln in want if "burst items" in ln or "replay" in ln]
    assert [ln for ln in lines if "burst items" in ln or "replay" in ln] \
        == hits
    board = [ln.split()[1:] for ln in want[-13:-3]]
    for i, name in enumerate(got["boards"]):
        assert got["boards"][name] == [int(row[i]) for row in board], name
