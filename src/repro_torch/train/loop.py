"""Fault-tolerant training loop, PyTorch.

Counterpart of `repro/train/loop.py`.  The loop owns nothing the
checkpoint doesn't: (params, opt_state, step, rng, extras) all live in
`TrainState`, and the data pipeline is stateless-indexed by step, so a
restart resumes from the last checkpoint.  Failure handling:

  * checkpoint every `ckpt_every` steps (`train/checkpoint.save_async`,
    atomic publish), in the reference's format: `TrainState.tree()`
    flattens to its leaf paths (`0/...` params, `1/...` opt_state, `2`
    step, `3` rng, `4/...` extras), so a checkpoint the JAX loop wrote
    restores here;
  * a step whose loss is non-finite is retried once with the same batch,
    then skipped with the state as it was before the step;
  * on restart, `run` restores the latest checkpoint and fast-forwards
    the stateless pipeline to the restored step.

Steps run eagerly (no `torch.compile`), and the optimizer updates in
place (`train/optimizer.py`).  So that a retry still finds the state
from before the step, a step whose loss is non-finite applies no update:
it returns the state's params and optimizer state untouched (the
reference's step would return updated ones, which its `run` discards).
Checking the loss costs one synchronize a step, as the reference's
`run` pays reading it.  The rng is a raw threefry key (a (2,) uint32
array) split each step with `core/prng.split`, bit for bit the
reference's `jax.random.split` stream.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.params import flatten, tree_map, unflatten
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor   # int32 0-dim tensor on the host
    rng: np.ndarray      # raw threefry key, (2,) uint32
    extras: Any = None   # e.g. sketch tables, EF residuals

    def tree(self) -> list:
        """The leaves in the reference's pytree order."""
        return [self.params, self.opt_state, self.step, self.rng,
                self.extras]


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    label_fn=None, accum: int = 1):
    """loss_fn(params, batch, rng) -> (loss, metrics). Returns (init, step).

    With accum > 1 every batch leaf is (accum, micro, ...): the
    microbatches' gradients are summed one at a time, then divided by
    accum (metrics are then {} beside the loss, as in the reference)."""
    kwargs = {} if label_fn is None else {"label_fn": label_fn}
    opt_init, opt_update = make_optimizer(opt_cfg, **kwargs)

    def init_state(params, rng) -> TrainState:
        return TrainState(params=params, opt_state=opt_init(params),
                          step=torch.zeros((), dtype=torch.int32),
                          rng=np.asarray(rng, np.uint32))

    def grads_of(params, batch, rng):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten(params).items()}
        with torch.enable_grad():
            loss, metrics = loss_fn(unflatten(leaves), batch, rng)
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), gs)}
        metrics = {k: m.detach() for k, m in metrics.items()}
        return loss.detach(), metrics, unflatten(grads)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        rng, sub = prng.split(state.rng, 2)
        if accum == 1:
            loss, metrics, grads = grads_of(state.params, batch, sub)
        else:
            grads, loss, metrics = None, 0.0, {}
            for i in range(accum):
                mb = tree_map(lambda v, i=i: v[i], batch)
                l_i, _, g = grads_of(state.params, mb, sub)
                if grads is None:
                    grads = g
                else:
                    for acc, gi in zip(flatten(grads).values(),
                                       flatten(g).values()):
                        acc.add_(gi)
                loss = loss + l_i
            for g in flatten(grads).values():
                g.div_(accum)
            loss = loss / accum
        if not bool(torch.isfinite(loss)):
            # no update: `run` retries from this very state
            return (dataclasses.replace(state, step=state.step + 1, rng=rng),
                    {"loss": loss, **metrics})
        new_params, new_opt, stats = opt_update(grads, state.opt_state,
                                                state.params, state.step)
        new_state = TrainState(params=new_params, opt_state=new_opt,
                               step=state.step + 1, rng=rng,
                               extras=state.extras)
        return new_state, {"loss": loss, **metrics, **stats}

    return init_state, train_step


def run(state: TrainState, step_fn, batches, *, n_steps: int,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
        log_every: int = 10, log_fn=print) -> TrainState:
    """Drive `step_fn` with retry-once / skip-on-nonfinite and checkpoints.

    `batches`: iterable of (step, batch), e.g. a data.pipeline.Prefetcher.
    """
    if ckpt_dir is not None and ckpt_lib.latest_step(ckpt_dir) is not None:
        restored, manifest = ckpt_lib.restore(ckpt_dir, state.tree())
        state = TrainState(*restored)
        log_fn(f"[loop] restored checkpoint at step {manifest['step']}")

    start = int(state.step)
    t0 = time.time()
    pending_save = None
    for step, batch in batches:
        if step < start:
            continue  # stateless pipeline fast-forward
        if step >= n_steps:
            break
        prev = state
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            state, metrics = step_fn(prev, batch)   # retry once (SDC guard)
            if not math.isfinite(float(metrics["loss"])):
                log_fn(f"[loop] step {step}: non-finite loss twice, skipping")
                state = dataclasses.replace(prev, step=prev.step + 1)
                continue
        if log_every and step % log_every == 0:
            rate = (step - start + 1) / max(time.time() - t0, 1e-9)
            log_fn(f"[loop] step {step} loss {loss:.4f} "
                   f"({rate:.2f} steps/s)")
        if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
            pending_save = ckpt_lib.save_async(ckpt_dir, step + 1,
                                               state.tree())
    if pending_save is not None:
        pending_save.join(timeout=60)  # don't orphan the last atomic publish
    return state
