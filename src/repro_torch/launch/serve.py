"""Serving driver, PyTorch: batched prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --batch 4 --prompt-len 64 --gen 32 [--device cpu] [--mesh [--model 2]]

Counterpart of `repro/launch/serve.py`: the arch's smoke config, random
weights (a `torch.Generator` from `--seed`, not the reference's bits),
the prompt `jax.random.randint(PRNGKey(seed + 1), ...)` bit for bit
(`core/prng.randint` on the raw key (0, seed + 1)), then
prefill(tokens) -> cache and decode_step(cache, token) -> next-token
logits, with the reference's two printed lines.  With --mesh, the
reference's `use_rules(LM_DECODE_RULES, mesh)` on the host mesh (as
`launch/train.py --mesh`): the weights placed by `tree_shardings` under
the decode rules, the prompt by its ("batch", None) axes, and prefill
and decode run on DTensors.  Runs on CUDA unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import sharding
from repro_torch.configs import registry
from repro_torch.core import prng
from repro_torch.core.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.models.params import distribute_tree, init_tree, tree_shardings


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(params, prompt, cfg: tf.LMConfig, gen: int):
    """Prefill `prompt` (B, P), then gen - 1 greedy decode steps.
    Returns (tokens (B, gen), prefill seconds, decode seconds)."""
    dev = prompt.device
    p_len = prompt.shape[1]
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, prompt, cfg, max_len=p_len + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    # the position stays on the device: no upload (and synchronize) a step
    pos = torch.full((), p_len, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = tf.decode_step(params, cache, tok, pos, cfg)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
        pos = pos + 1
    toks = torch.cat(out, dim=1)
    if hasattr(toks, "full_tensor"):
        toks = toks.full_tensor()
    _sync(dev)
    return toks, t_prefill, time.perf_counter() - t0


def main(argv=None):
    """Returns (params, prompt, generated tokens) for callers that check."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mesh", action="store_true",
                    help="place on the host mesh (sharding.use_rules)")
    ap.add_argument("--model", type=int, default=1, help="model axis size")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = registry.get(args.arch)
    cfg: tf.LMConfig = arch.smoke_cfg
    if cfg.window:  # keep the smoke window sane vs the requested lengths
        cfg = dataclasses.replace(cfg, window=max(cfg.window, 16))

    params = init_tree(tf.param_specs(cfg), args.seed, device=dev)
    prompt = prng.randint((0, args.seed + 1), (args.batch, args.prompt_len),
                          0, cfg.vocab_size, device=dev)
    if args.mesh:
        mesh = mesh_lib.host_mesh_on(dev, args.model)
        rules = sharding.LM_DECODE_RULES
        placed = distribute_tree(
            params, tree_shardings(tf.param_specs(cfg), rules, mesh), mesh)
        tokens = sharding.distribute(prompt, mesh, sharding.sharding_for(
            ("batch", None), rules, mesh, prompt.shape))
        with sharding.use_rules(rules, mesh):
            toks, t_prefill, t_decode = generate(placed, tokens, cfg,
                                                 args.gen)
    else:
        toks, t_prefill, t_decode = generate(params, prompt, cfg, args.gen)

    toks_s = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] {arch.name} (smoke cfg): prefill {args.prompt_len} "
          f"tok x{args.batch} in {t_prefill*1e3:.0f} ms; "
          f"decode {toks_s:.0f} tok/s")
    print("[serve] sample:", toks[0, :16].tolist())
    return params, prompt, toks


if __name__ == "__main__":
    main()
