"""Sketch-gated embedding admission (PyTorch port): the paper's technique
in its production recsys role.

A DLRM-style model trains on a Zipfian click stream while a CMLS sketch
counts raw ids; ids are only admitted to private embedding rows once hot.
We compare final BCE against hash-everything (all ids share buckets).
The same stream, admission draws (the raw keys split from the
reference's `PRNGKey(1)` with `core/prng.split`) and flow as
`examples/recsys_admission.py`.  As there, all 8 fields are counted in
ONE sketch, so equal raw ids of different fields share a key (and a
count).  The counts line is `sk.query`, which decodes as the reference's
`sk.query` does op by op, so it prints the reference's integers on every
device (a state-1 estimate is 0.99999988, which `int` prints as 0).
The weights come from a `torch.Generator` unless `params0` (a
numpy tree, e.g. the reference's `init_tree(..., PRNGKey(0))`) is given.
Runs on the GPU unless `--device cpu`; there the admission counts
through the CUDA kernels (`ops.update_chunked`, then `ops.query`).

    PYTHONPATH=src python examples/recsys_admission_torch.py [--steps 60]
        [--batch 512] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import CMLS16, SketchSpec, admission, prng
from repro_torch.core import sketch as sk
from repro_torch.core.device import resolve_device
from repro_torch.data import recsys_stream
from repro_torch.models import recsys as rs
from repro_torch.models.params import init_tree
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig

TABLE = [20_000] * 8  # 8 sparse fields, 20k raw ids each, heavy Zipf skew
A = admission.AdmissionSpec(threshold=6.0, n_fallback=256, table_rows=4_096)
CFG = rs.DLRMConfig(n_dense=13, embed_dim=16, bot_mlp=(13, 64, 16),
                    top_mlp=(64, 32, 1),
                    table_sizes=tuple([A.n_fallback + A.table_rows] * 8))
POLICIES = ("admission", "hash_all")


def raw_key(seed: int) -> np.ndarray:
    """The raw threefry key the reference's `jax.random.PRNGKey(seed)` is."""
    return np.array([0, seed], np.uint32)


def main(argv=None, params0=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    sketch = sk.init(SketchSpec.from_memory(64 * 1024, depth=2,
                                            counter=CMLS16), device=dev)

    def batches(policy: str):
        nonlocal sketch
        rng = raw_key(1)
        for step in range(args.steps):
            b = recsys_stream.dlrm_batch(step, 0, 1, global_batch=args.batch,
                                         table_sizes=TABLE, seed=3)
            raw = torch.from_numpy(b["sparse"]).to(dev)
            if policy == "admission":
                rng, k = prng.split(rng, 2)
                flat = raw.reshape(-1).to(torch.int64).to(torch.uint32)
                sketch, rows, _ = admission.observe_and_admit(
                    sketch, flat, k, A)
                mapped = rows.reshape(raw.shape)
            else:  # hash_all
                mapped = raw % (A.n_fallback + A.table_rows)
            yield step, {"dense": torch.from_numpy(b["dense"]).to(dev),
                         "sparse": mapped,
                         "label": torch.from_numpy(b["label"]).to(dev)}

    bce, losses = {}, {}
    for policy in POLICIES:
        if params0 is None:
            params = init_tree(rs.dlrm_specs(CFG), 0, dev)
        else:
            params = convert.params_from_numpy(params0, dev)
        init_state, step_fn = make_train_step(
            lambda p, bt, r: rs.dlrm_loss(p, bt, CFG),
            OptimizerConfig(peak_lr=2e-3, warmup_steps=5,
                            decay_steps=args.steps))
        state = init_state(params, raw_key(2))
        losses[policy] = []
        for _, batch in batches(policy):
            state, metrics = step_fn(state, batch)
            losses[policy].append(float(metrics["loss"]))
        bce[policy] = float(np.mean(losses[policy][-10:]))
        print(f"{policy:10s} final BCE (last-10 mean) = {bce[policy]:.4f}")

    hot = torch.arange(16, device=dev).to(torch.uint32)
    est = sk.query(sketch, hot)
    counts = [int(x) for x in est.cpu()]
    print("\nsketch counts for the 16 hottest raw ids:", counts)
    table_line = (f"admission table: {A.table_rows} private rows + "
                  f"{A.n_fallback} shared fallback rows vs {sum(TABLE)} "
                  f"raw ids")
    print(table_line)
    return {"bce": bce, "losses": losses, "counts": counts,
            "table_line": table_line}


if __name__ == "__main__":
    main()
