"""The paper's Figure 1 sweep on the JAX reference, on the CPU: ARE of
every variant and byte budget of `PaperSketchConfig` over the calibrated
500k-token corpus, counted the way `chip_smoke.py` phase 13 counts it on
the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/paper_are_reference.py \
        [--tokens 500000]

The stream is `ngrams.event_stream` of `corpus.generate` (about 1.0 M
events, 232,898 distinct); each sketch takes it in chunks of 131,072
through `update_batched` with keys split from the raw key (0, 0)
(`benchmarks/common.py` `count_stream(mode="batched")`), and ARE is
mean(|query - true| / true) over the distinct keys.  The tool imports
JAX (the reference); the port never does.  Prints one line a sketch and one JSON line last.
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.paper_sketch import CFG
from repro.core import sketch as sk
from repro.data import corpus, ngrams

CHUNK = 131_072


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=500_000)
    args = ap.parse_args(argv)
    toks = corpus.generate(corpus.CorpusSpec(n_tokens=args.tokens))
    events = ngrams.event_stream(toks)
    uniq, true = ngrams.exact_counts(events)
    upd = jax.jit(sk.update_batched)
    are = {}
    for variant in CFG.variants:
        are[variant] = {}
        for budget in CFG.budgets:
            s = sk.init(CFG.spec(variant, budget))
            rng = jax.random.PRNGKey(0)
            for i in range(0, len(events), CHUNK):
                rng, k = jax.random.split(rng)
                s = upd(s, jnp.asarray(events[i:i + CHUNK]), k)
            est = np.asarray(sk.query(s, jnp.asarray(uniq)))
            are[variant][budget] = float(np.mean(np.abs(est - true) / true))
            print(f"{variant:10s} {budget // 1024:5d} kB  ARE "
                  f"{are[variant][budget]:.6f}", flush=True)
    print(json.dumps({"events": int(events.size),
                      "distinct": int(uniq.size), "are": are}))
    return are


if __name__ == "__main__":
    main()
