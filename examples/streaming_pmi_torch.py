"""Streaming PMI (PyTorch port): the paper's NLP use case end to end.

Counts the unigrams and bigrams of the calibrated 500k-word corpus in ONE
CMLS16 sketch, then ranks word pairs by sketch-estimated PMI and compares
against PMI from exact counts (paper §3.4).  The same corpus, chunks and
draws as `examples/streaming_pmi.py`, so the same numbers.

    PYTHONPATH=src python examples/streaming_pmi_torch.py [--budget-kb 256]
        [--tokens 500000] [--device cpu]

Runs on the GPU unless `--device cpu`; the probes go through `ops.query`
(the fused query kernel there).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import CMLS16, SketchSpec, init, prng, update_batched
from repro_torch.core import estimators
from repro_torch.core.counters import from_numpy
from repro_torch.core.device import resolve_device
from repro_torch.core.hashing import combine2
from repro_torch.data import corpus, ngrams
from repro_torch.kernels import ops

CHUNK = 131_072


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget-kb", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=500_000)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    toks = corpus.generate(corpus.CorpusSpec(n_tokens=args.tokens))
    events = ngrams.event_stream(toks)
    print(f"corpus: {len(toks)} tokens -> {len(events)} counting events")

    spec = SketchSpec.from_memory(args.budget_kb * 1024, depth=2,
                                  counter=CMLS16)
    sketch = init(spec, device=dev)
    rng = np.array([0, 0], np.uint32)
    for i in range(0, len(events), CHUNK):  # streaming chunks
        rng, k = prng.split(rng, 2)
        sketch = update_batched(sketch, from_numpy(events[i:i + CHUNK], dev),
                                k)
    print(f"sketch: {spec.depth}x{spec.width} CMLS16 cells "
          f"({spec.memory_bytes // 1024} kB)")

    # PMI over bigrams seen >= 5 times
    left, right = ngrams.bigram_pairs(toks)
    pairs, counts = np.unique(np.stack([left, right]), axis=1,
                              return_counts=True)
    sel = counts >= 5
    l, r = from_numpy(pairs[0, sel], dev), from_numpy(pairs[1, sel], dev)
    n_uni, n_bi = float(len(toks)), float(len(toks) - 1)
    est_l, est_r = ops.query(sketch, l), ops.query(sketch, r)
    est_b = ops.query(sketch, combine2(l, r))
    pmi_est = estimators.pmi_exact(est_l, est_r, est_b, n_uni,
                                   n_bi).cpu().numpy()

    uc = np.bincount(toks, minlength=int(toks.max()) + 1)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    pmi_true = estimators.pmi_exact(
        f32(uc[pairs[0, sel]]), f32(uc[pairs[1, sel]]), f32(counts[sel]),
        n_uni, n_bi).cpu().numpy()

    rmse = float(np.sqrt(np.mean((pmi_est - pmi_true) ** 2)))
    print(f"PMI over {sel.sum()} bigrams: RMSE vs exact counts = {rmse:.4f}")

    order = np.argsort(-pmi_est)[:10]
    top = []
    print("\ntop-10 pairs by sketch PMI (pmi_est / pmi_true):")
    for i in order:
        pair = (int(pairs[0, sel][i]), int(pairs[1, sel][i]))
        top.append(pair)
        print(f"  ({pair[0]:6d},{pair[1]:6d})  "
              f"{pmi_est[i]:6.2f} / {pmi_true[i]:6.2f}")
    return {"events": int(len(events)), "bigrams": int(sel.sum()),
            "rmse": rmse, "top10": top,
            "pairs": [tuple(int(x) for x in p) for p in pairs[:, sel].T],
            "pmi_est": pmi_est}


if __name__ == "__main__":
    main()
