"""Optimizers built from scratch: AdamW (dense) + row-wise Adagrad (tables).

Counterpart of `repro/train/optimizer.py`, in PyTorch.  Production
embedding tables cannot afford Adam's 2x fp32 moments; the industry
standard is row-wise Adagrad: ONE fp32 accumulator per row.
`make_optimizer` partitions the param tree by a label function (paths
such as `tables/t0` or `user_table` are tables) and applies the right
rule per leaf.

Unlike the reference's pure update, the port updates IN PLACE, leaf by
leaf: the gradients are scaled by the clip factor where they lie, then
each leaf's moments or accumulator and the leaf itself are updated, so
the peak memory is the params, their gradients and one leaf's
temporaries (a 13 GiB table tree is never copied whole).  The float32
math follows the reference expression for expression; the schedule's
scalars (`lr`, `b1 ** t`) are 0-dim float32 tensors on the step's
device (the host, in `train/loop.py`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.params import P, flatten, unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    table_lr: float = 0.01        # row-wise adagrad learning rate
    table_eps: float = 1e-8


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * peak (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in flatten(tree).values()))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled IN PLACE so their global norm is at most max_norm,
    the norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in flatten(grads).values():
        g.mul_(scale)
    return grads, norm


def default_label_fn(path: str) -> str:
    """Tables (embedding-style 2D giants) get row-wise adagrad."""
    for marker in ("tables/", "user_table", "item_table", "items"):
        if marker in path or path.endswith(marker.rstrip("/")):
            return "table"
    return "dense"


def _node(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def make_optimizer(cfg: OptimizerConfig,
                   label_fn: Callable[[str], str] = default_label_fn):
    """Returns (init_fn, update_fn).

    init_fn(params) -> opt_state (a dict per leaf: {"acc"} for a table,
    {"mu", "nu"} otherwise, as the reference's tree);
    update_fn(grads, opt_state, params, step) -> (params, opt_state,
    stats), with params, opt_state and grads updated in place.
    """

    def init_fn(params):
        flat = {}
        for path, p in flatten(params).items():
            if label_fn(path) == "table":
                flat[f"{path}/acc"] = torch.zeros(
                    (p.shape[0],), dtype=torch.float32, device=p.device)
            else:
                flat[f"{path}/mu"] = torch.zeros_like(p, dtype=torch.float32)
                flat[f"{path}/nu"] = torch.zeros_like(p, dtype=torch.float32)
        return unflatten(flat)

    @torch.no_grad()
    def update_fn(grads, opt_state, params, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        lr = lr_schedule(cfg, step)
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        flat_g = flatten(grads)
        for path, p in flatten(params).items():
            g = flat_g[path].float()
            s = _node(opt_state, path)
            if label_fn(path) == "table":
                # row-wise adagrad: accumulate mean-square per row
                row_ms = torch.mean(torch.square(g),
                                    dim=tuple(range(1, g.ndim)))
                acc = s["acc"].add_(row_ms)
                # eps inside the sqrt + floor: untouched rows (acc == 0,
                # g == 0) must stay exactly unchanged, not become 0 * inf
                scale = cfg.table_lr / torch.sqrt(
                    torch.clamp(acc + cfg.table_eps, min=1e-30))
                g.mul_(scale.reshape((-1,) + (1,) * (g.ndim - 1)))
                p.sub_(g.to(p.dtype))
                continue
            mu = s["mu"].mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu = s["nu"].mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            mu_hat = mu / (1 - torch.pow(cfg.b1, t))
            nu_hat = nu / (1 - torch.pow(cfg.b2, t))
            upd = mu_hat / (torch.sqrt(nu_hat) + cfg.eps) \
                + cfg.weight_decay * p
            p.sub_((lr * upd).to(p.dtype))
        return params, opt_state, {"grad_norm": gnorm, "lr": lr}

    return init_fn, update_fn


def opt_state_specs(param_specs_tree, label_fn=default_label_fn):
    """P-spec tree for the optimizer state (memory accounting)."""
    flat = {}
    for path, spec in flatten(param_specs_tree).items():
        if label_fn(path) == "table":
            flat[f"{path}/acc"] = P((spec.shape[0],),
                                    (spec.axes[0],) if spec.axes else None,
                                    "zeros", torch.float32)
        else:
            flat[f"{path}/mu"] = P(spec.shape, spec.axes, "zeros",
                                   torch.float32)
            flat[f"{path}/nu"] = P(spec.shape, spec.axes, "zeros",
                                   torch.float32)
    return unflatten(flat)
