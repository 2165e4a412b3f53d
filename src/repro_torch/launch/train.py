"""End-to-end training driver, PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --preset 100m --steps 300 --batch 16 --seq 512 --sketch [--device cpu]
        [--mesh [--model 2]]

Counterpart of `repro/launch/train.py`: trains an LM (a registered
arch's smoke config with the corpus's vocabulary, or a preset) on the
synthetic Zipf corpus with AdamW, checkpoints and the fault-tolerant
loop (`train/loop.py`), and with --sketch the CMLS counting plane over
the training token stream: each step's batch goes into a CMLS16 sketch
as its unigrams and bigrams, `core/sketch.update_batched` (the one-shot
update of the reference, not the kernels' chunked update, which would
count differently) on concat(flat, combine2(flat[:-1], flat[1:])) with
the raw key (0, step).  As in the reference, the batch source runs one
step ahead of the loop, so the sketch also counts the batch of step
`--steps`, which the loop then stops before training on.

With --mesh, the reference's placement: under
`sharding.use_rules(LM_RULES, mesh)` on `launch/mesh.make_host_mesh`
(world / model x model, over the group `launch/mesh.init_group` made:
NCCL on the card, gloo with --device cpu; a one-rank group is made if
none is), the parameters are placed by `tree_shardings`, each batch by
its ("batch", None) axes, and the optimizer state and the steps run on
DTensors.  Every rank of the group runs `main` with the same arguments.

Weights come from a `torch.Generator` (not the reference's bits), or
from `params` (a numpy tree, e.g. the reference's init, placed by
`train/checkpoint.place`).  --full trains the arch's full config in
place of its smoke config.  Runs on CUDA unless `--device cpu`.  `main`
returns the final `TrainState` and the sketch (None without --sketch),
and given a dict `record`, fills its lists "loss" and "step_ms" (each
step's loss, and its wall time with the device synchronized).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs import registry
from repro_torch.core import CMLS16, SketchSpec
from repro_torch.core import sketch as sk
from repro_torch.core.device import resolve_device
from repro_torch.core.hashing import combine2
from repro_torch.data import corpus as corpus_lib
from repro_torch.data import pipeline as pipe
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import _sync
from repro_torch.models import transformer as tf
from repro_torch.models.params import (abstract_tree, distribute_tree,
                                       flatten, init_tree, param_count,
                                       tree_shardings)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import loop as loop_lib
from repro_torch.train.optimizer import OptimizerConfig


def preset_100m(vocab: int) -> tf.LMConfig:
    """~100M-parameter decoder (12L x 768, GQA 12/4)."""
    return tf.LMConfig(name="preset-100m", n_layers=12, d_model=768,
                       n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048,
                       vocab_size=vocab, tie_embeddings=True,
                       pattern=("global",) * 2, dtype=torch.bfloat16)


def preset_25m(vocab: int) -> tf.LMConfig:
    """~25M-parameter decoder -- the 1-CPU-core budget version of the
    end-to-end driver (same code path as 100m; pick by wall-clock)."""
    return tf.LMConfig(name="preset-25m", n_layers=6, d_model=384,
                       n_heads=6, n_kv_heads=2, d_head=64, d_ff=1024,
                       vocab_size=vocab, tie_embeddings=True,
                       pattern=("global",) * 2, dtype=torch.bfloat16)


def sketch_keys(tokens: np.ndarray, device) -> torch.Tensor:
    """A batch's unigram and bigram keys: concat(flat, combine2(flat[:-1],
    flat[1:])), uint32 values in int64."""
    flat = torch.from_numpy(tokens.reshape(-1).astype(np.int64)).to(device)
    return torch.cat([flat, combine2(flat[:-1], flat[1:])])


def main(argv=None, params=None, record=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="registered arch (smoke cfg)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config, not its smoke config")
    ap.add_argument("--preset", default=None, choices=[None, "100m", "25m"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--sketch", action="store_true",
                    help="run the CMLS counting plane on the token stream")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mesh", action="store_true",
                    help="place on the host mesh (sharding.use_rules)")
    ap.add_argument("--model", type=int, default=1, help="model axis size")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = mesh_lib.host_mesh_on(dev, args.model) if args.mesh else None
    rules = sharding.LM_RULES

    corpus_spec = corpus_lib.CorpusSpec(n_tokens=2_000_000)
    tokens = corpus_lib.generate(corpus_spec)

    if args.preset == "100m":
        cfg = preset_100m(corpus_spec.vocab_size)
    elif args.preset == "25m":
        cfg = preset_25m(corpus_spec.vocab_size)
    elif args.full:
        cfg = registry.get(args.arch or "qwen2-0.5b").cfg
    else:
        arch = registry.get(args.arch or "qwen2-0.5b")
        cfg = dataclasses.replace(arch.smoke_cfg,
                                  vocab_size=corpus_spec.vocab_size)
    print(f"[train] model {cfg.name}: "
          f"{param_count(tf.param_specs(cfg)) / 1e6:.1f}M params")

    specs = tf.param_specs(cfg)
    if params is not None:  # numpy leaves: placed as the targets ask
        target = (abstract_tree(specs, rules, mesh) if mesh is not None
                  else init_tree(specs, args.seed, device=dev))
        params = ckpt_lib.place(flatten(params), target, dev)
    else:
        params = init_tree(specs, args.seed, device=dev)
        if mesh is not None:
            params = distribute_tree(
                params, tree_shardings(specs, rules, mesh), mesh)

    def loss(p, batch, rng):
        return tf.loss_fn(p, {"tokens": batch["tokens"],
                              "targets": batch["targets"]}, cfg)

    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=args.steps // 10,
                              decay_steps=args.steps)
    init_state, step_fn = loop_lib.make_train_step(loss, opt_cfg)
    if record is not None:
        inner = step_fn

        def step_fn(state, batch):
            _sync(dev)
            t0 = time.perf_counter()
            state, metrics = inner(state, batch)
            loss = float(metrics["loss"])
            _sync(dev)
            record.setdefault("step_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
            record.setdefault("loss", []).append(loss)
            return state, metrics

    state = init_state(params, np.array([0, args.seed + 1], np.uint32))

    held = {"sketch": sk.init(SketchSpec.from_memory(
        1 << 20, depth=2, counter=CMLS16), device=dev)
        if args.sketch else None}

    src = pipe.token_batch_source(tokens, args.batch, args.seq, args.seed)
    prefetch = pipe.Prefetcher(src, shard=0, n_shards=1, depth=4)

    def batches():
        for step, b in prefetch:
            if held["sketch"] is not None:
                held["sketch"] = sk.update_batched(  # jitted there
                    held["sketch"], sketch_keys(b["tokens"], dev),
                    np.array([0, step], np.uint32), eager=False)
            b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            if mesh is not None:
                b = {k: sharding.distribute(v, mesh, sharding.sharding_for(
                    ("batch", None), rules, mesh, v.shape))
                    for k, v in b.items()}
            yield step, b

    placed = (sharding.use_rules(rules, mesh) if mesh is not None
              else contextlib.nullcontext())
    try:
        with placed:
            state = loop_lib.run(state, step_fn, batches(),
                                 n_steps=args.steps, ckpt_dir=args.ckpt_dir,
                                 ckpt_every=args.ckpt_every)
    finally:
        prefetch.close()

    sketch = held["sketch"]
    if sketch is not None:
        top = np.argsort(-np.bincount(tokens[:100_000], minlength=50))[:8]
        est = sk.query(sketch, torch.from_numpy(top.astype(np.int64)).to(dev))
        print("[train] sketch estimates for top tokens:",
              {int(t): round(float(e)) for t, e in zip(top, est)})
    print(f"[train] done at step {int(state.step)}")
    return state, sketch


if __name__ == "__main__":
    main()
