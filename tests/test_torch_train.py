"""The port's training path against the JAX package's (CPU).

  * `train/optimizer.py`: `lr_schedule`, `global_norm`,
    `clip_by_global_norm` (in place in the port), `default_label_fn`,
    `opt_state_specs`, and AdamW plus row-wise Adagrad through
    `make_optimizer` beside the reference's, rows no gradient touched
    exactly unchanged;
  * `train/loop.py`: five `make_train_step` steps of the DLRM smoke
    config from a `TrainState` carried across with
    `convert.train_state_from_numpy`, with `accum` 1 and 2; `run`'s
    retry and skip on a non-finite loss; a checkpoint the JAX loop wrote
    restored and continued by the port loop, and the leaf paths of
    `TrainState.tree()`;
  * `models/recsys.dlrm_train_step_sparse` (the unsharded branch, at
    tests/test_perf_paths.py:51's config, three steps): losses, dense
    parameters and moments, tables and row accumulators beside the
    reference's, table rows no id touched exactly unchanged;
  * `examples/recsys_admission_torch.py` beside the reference example
    run as a subprocess (`--steps 8 --batch 256`) from the reference's
    initial weights.

Tolerances: steps, raw keys, admission rows and the example's counts
and table lines are exact, as are table rows no gradient touched.
Float32 values are held by their normwise relative error (max |port -
ref| / max |ref|): the schedule's scalars to 1e-6 (cos and pow rounded
by two libraries); one optimizer update to 1e-5; losses and parameters
after five train steps to 1e-4 (each step's gradients sum in another
order, measured below 2e-6 per step in tests/test_torch_recsys.py, and
Adam's normalised update carries that on).  The example's BCE agrees
with the reference's printed 4-decimal value within 5e-5 (its rounding)
+ 1e-6 (measured 1.5e-8 at these flags, 6e-9 at the defaults).
"""
import dataclasses
import math
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

from repro.configs import dlrm_mlperf as jdlrm_cfg
from repro.data import recsys_stream as jstream
from repro.models import params as jparams
from repro.models import recsys as jrs
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.models import params as tparams
from repro_torch.models import recsys as trs
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import recsys_admission_torch  # noqa: E402

SCALAR = 1e-6
UPDATE = 1e-5
STEPS = 1e-4


def rel_err(port, ref) -> float:
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(initial=0.0), 1e-30)
    return float(np.abs(port - ref).max(initial=0.0) / scale)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_trees(port_tree, ref_tree, tol):
    tflat = {k: v for k, v in tparams.flatten(port_tree).items()}
    jflat = _jflat(ref_tree)
    assert set(tflat) == set(jflat)
    for k in tflat:
        assert rel_err(tflat[k], jflat[k]) <= tol, k


def _cfgs():
    return [topt.OptimizerConfig(),
            topt.OptimizerConfig(peak_lr=2e-3, warmup_steps=5,
                                 decay_steps=60),
            topt.OptimizerConfig(peak_lr=1.0, warmup_steps=10,
                                 decay_steps=110, min_lr_ratio=0.1),
            topt.OptimizerConfig(warmup_steps=0, decay_steps=1)]


def _jcfg(cfg):
    return jopt.OptimizerConfig(**dataclasses.asdict(cfg))


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(4))
def test_lr_schedule_matches(i):
    cfg = _cfgs()[i]
    for step in (0, 1, 2, 4, 5, 6, 9, 10, 11, 33, 60, 99, 100, 101, 5000,
                 9999, 10_000, 20_000):
        want = float(jopt.lr_schedule(_jcfg(cfg), jnp.asarray(step)))
        got = topt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=SCALAR, abs=1e-12)


def _grad_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    g = {"bot": {"w0": rng.normal(size=(13, 8)), "b0": rng.normal(size=8)},
         "tables": {"t0": rng.normal(size=(40, 4)),
                    "t1": rng.normal(size=(30, 4))},
         "user_table": rng.normal(size=(20, 4))}
    g = jax.tree_util.tree_map(lambda a: (a * scale).astype(np.float32), g)
    # rows no batch touched have exactly zero gradient
    for leaf, rows in ((g["tables"]["t0"], slice(5, 25)),
                       (g["user_table"], slice(0, 7))):
        leaf[rows] = 0.0
    return g


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "clipped"])
def test_global_norm_and_clip_in_place(scale):
    g = _grad_tree(0, scale)
    jclipped, jnorm = jopt.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), 1.0)
    tg = convert.params_from_numpy(g, "cpu")
    assert rel_err(topt.global_norm(tg), jopt.global_norm(g)) <= SCALAR
    out, norm = topt.clip_by_global_norm(tg, 1.0)
    assert out is tg and rel_err(norm, jnorm) <= SCALAR
    _close_trees(tg, jclipped, SCALAR)


def test_default_label_fn_matches():
    for path in ("tables/t0", "tables/t25", "user_table", "item_table",
                 "items", "bot/w0", "top/b3", "user_tower/w1",
                 "item_tower/b0", "pos", "blocks/b0/ff1", "tables"):
        assert topt.default_label_fn(path) == jopt.default_label_fn(path)


def test_opt_state_specs_match():
    jspecs = jopt.opt_state_specs(jrs.dlrm_specs(jdlrm_cfg.SMOKE))
    tspecs = topt.opt_state_specs(trs.dlrm_specs(trs.DLRMConfig(
        **dataclasses.asdict(jdlrm_cfg.SMOKE))))
    jleaves = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jparams.P))[0]
    want = {"/".join(str(k.key) for k in p): (s.shape, s.axes, s.init)
            for p, s in jleaves}
    got = {k: (s.shape, s.axes, s.init)
           for k, s in tparams.flatten(tspecs).items()}
    assert got == want


@pytest.mark.parametrize("i", range(4))
def test_make_optimizer_matches_reference(i):
    """Three updates of AdamW (dense leaves) and row-wise Adagrad (tables)
    from the same params and grads: params and state within UPDATE, and
    table rows no gradient touched bit-identical to their start."""
    cfg = _cfgs()[i]
    rng = np.random.default_rng(7)
    p0 = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        _grad_tree(0))
    jinit, jupdate = jopt.make_optimizer(_jcfg(cfg))
    tinit, tupdate = topt.make_optimizer(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jinit(jp)
    tp = convert.params_from_numpy(p0, "cpu")
    ts = tinit(tp)
    assert set(tparams.flatten(ts)) == set(_jflat(js))
    for step in range(3):
        g = _grad_tree(10 + step, scale=0.1 * (step + 1))
        jp, js, jstats = jupdate(jax.tree_util.tree_map(jnp.asarray, g), js,
                                 jp, jnp.asarray(step))
        tp2, ts2, tstats = tupdate(convert.params_from_numpy(g, "cpu"), ts,
                                   tp, torch.tensor(step, dtype=torch.int32))
        assert tp2 is tp and ts2 is ts
        _close_trees(tp, jp, UPDATE)
        _close_trees(ts, js, UPDATE)
        for k in ("grad_norm", "lr"):
            assert rel_err(tstats[k], jstats[k]) <= SCALAR
    for path, rows in (("tables/t0", slice(5, 25)),
                       ("user_table", slice(0, 7))):
        start = tparams.flatten(p0)[path][rows]
        got = tparams.flatten(tp)[path][rows].numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      start.view(np.int32))
        acc = tparams.flatten(ts)[f"{path}/acc"][rows]
        assert not acc.any()


def test_reference_unit_math():
    """The reference's own optimizer cases (tests/test_train.py)."""
    cfg = topt.OptimizerConfig(peak_lr=0.1, warmup_steps=0,
                               decay_steps=10**9, b1=0.9, b2=0.99, eps=1e-8,
                               weight_decay=0.0, grad_clip=1e9)
    init, update = topt.make_optimizer(cfg, label_fn=lambda p: "dense")
    p = {"w": torch.tensor([1.0, -2.0])}
    new_p, _, _ = update({"w": torch.tensor([0.5, 0.25])}, init(p), p,
                         torch.tensor(0))
    np.testing.assert_allclose(new_p["w"].numpy(), [0.9, -2.1], atol=1e-5)
    cfg = topt.OptimizerConfig(table_lr=1.0, table_eps=0.0, grad_clip=1e9)
    init, update = topt.make_optimizer(cfg, label_fn=lambda p: "table")
    p = {"t": torch.ones((2, 4))}
    state = init(p)
    assert state["t"]["acc"].shape == (2,)
    g = {"t": torch.tensor([[2.0] * 4, [0.0] * 4])}
    new_p, _, _ = update(g, state, p, torch.tensor(0))
    np.testing.assert_allclose(new_p["t"][0].numpy(), 0.0, atol=1e-4)
    assert torch.equal(new_p["t"][1], torch.ones(4))  # untouched, exactly


# --------------------------------------------------------------------------
# train steps and the loop
# --------------------------------------------------------------------------

def _dlrm_setup(accum):
    jc = jdlrm_cfg.SMOKE
    tc_ = trs.DLRMConfig(**dataclasses.asdict(jc))
    ocfg = topt.OptimizerConfig(peak_lr=2e-3, warmup_steps=2, decay_steps=5)
    jinit, jstep = jloop.make_train_step(
        lambda p, b, r: jrs.dlrm_loss(p, b, jc), _jcfg(ocfg), accum=accum)
    tinit, tstep = tloop.make_train_step(
        lambda p, b, r: trs.dlrm_loss(p, b, tc_), ocfg, accum=accum)
    jstate = jinit(jparams.init_tree(jrs.dlrm_specs(jc),
                                     jax.random.PRNGKey(0)),
                   jax.random.PRNGKey(2))
    return jc, jstep, tstep, jstate, tinit


def _batches(jc, n, accum, batch=64):
    for step in range(n):
        b = jstream.dlrm_batch(step, 0, 1, global_batch=batch,
                               table_sizes=list(jc.table_sizes))
        if accum > 1:
            b = {k: v.reshape((accum, batch // accum) + v.shape[1:])
                 for k, v in b.items()}
        yield step, b


def _state_np(jstate) -> dict:
    return {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
            "opt_state": jax.tree_util.tree_map(np.asarray, jstate.opt_state),
            "step": np.asarray(jstate.step), "rng": np.asarray(jstate.rng)}


def _same_state(tstate, jstate, tol=STEPS):
    _close_trees(tstate.params, jstate.params, tol)
    _close_trees(tstate.opt_state, jstate.opt_state, tol)
    assert int(tstate.step) == int(jstate.step)
    assert tstate.step.dtype == torch.int32
    np.testing.assert_array_equal(tstate.rng, np.asarray(jstate.rng))


@pytest.mark.parametrize("accum", [1, 2])
def test_five_train_steps_match_reference(accum):
    jc, jstep, tstep, jstate, _ = _dlrm_setup(accum)
    tstate = convert.train_state_from_numpy(_state_np(jstate), "cpu")
    jit_step = jax.jit(jstep)
    for _, b in _batches(jc, 5, accum):
        jstate, jm = jit_step(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in b.items()})
        assert rel_err(tm["loss"], jm["loss"]) <= STEPS
        assert set(tm) == set(jm)
    _same_state(tstate, jstate)
    back = convert.train_state_to_numpy(tstate)
    assert back["step"] == 5 and back["extras"] is None
    np.testing.assert_array_equal(back["rng"], np.asarray(jstate.rng))


def test_dlrm_train_step_sparse_matches_reference():
    jc = jrs.DLRMConfig(embed_dim=8, bot_mlp=(13, 16, 8), top_mlp=(16, 1),
                        table_sizes=tuple([64] * 4), sparse_update=True)
    tc_ = trs.DLRMConfig(**dataclasses.asdict(jc))
    ocfg = topt.OptimizerConfig(table_lr=0.1)
    jparams0 = jparams.init_tree(jrs.dlrm_specs(jc), jax.random.PRNGKey(0))
    zeros2 = lambda x: {"mu": jnp.zeros_like(x), "nu": jnp.zeros_like(x)}  # noqa
    jstate = {"dense": {"bot": jax.tree.map(zeros2, jparams0["bot"]),
                        "top": jax.tree.map(zeros2, jparams0["top"])},
              "tables": {f"t{i}": {"acc": jnp.zeros(64)} for i in range(4)}}
    tp = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams0), "cpu")
    ts = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    _, jdense = jopt.make_optimizer(_jcfg(ocfg), label_fn=lambda p: "dense")
    _, tdense = topt.make_optimizer(ocfg, label_fn=lambda p: "dense")
    jp = jparams0
    jstep = jax.jit(jrs.dlrm_train_step_sparse, static_argnums=(5, 6, 7))
    touched = np.zeros((4, 64), bool)
    for step, b in _batches(jc, 3, 1, batch=16):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jp, jstate, jm = jstep(jp, jstate, jb, jnp.asarray(step),
                               jnp.asarray(0), jc, _jcfg(ocfg), jdense)
        tp, ts, tm = trs.dlrm_train_step_sparse(
            tp, ts, {k: _t(v) for k, v in b.items()}, step, 0, tc_, ocfg,
            tdense)
        assert set(tm) == set(jm)
        assert rel_err(tm["loss"], jm["loss"]) <= STEPS
        for i in range(4):
            touched[i, b["sparse"][:, i]] = True
    _close_trees(tp, jp, STEPS)
    _close_trees(ts, jstate, STEPS)
    start = jax.tree_util.tree_map(np.asarray, jparams0["tables"])
    for i in range(4):
        moved = (tp["tables"][f"t{i}"].numpy() != start[f"t{i}"]).any(axis=1)
        assert np.array_equal(moved, touched[i]), i
        assert (ts["tables"][f"t{i}"]["acc"].numpy()[~touched[i]] == 0).all()


def test_train_state_tree_has_the_reference_leaf_paths(tmp_path):
    jc, jstep, tstep, jstate, tinit = _dlrm_setup(1)
    tstate = convert.train_state_from_numpy(_state_np(jstate), "cpu")
    want = {k: (v.shape, str(v.dtype))
            for k, v in jckpt._flatten(jstate).items()}
    got = {k: (np.shape(v), str(v.dtype))
           for k, v in tckpt.flatten(tckpt.to_host(tstate.tree())).items()}
    assert got == want
    # a port checkpoint restores into the reference's tree, and back
    tckpt.save(str(tmp_path), 7, tstate.tree())
    restored, _ = jckpt.restore(str(tmp_path), jstate)
    _same_state(tstate, restored, tol=0.0)


class _Flaky:
    """A DLRM loss whose value is NaN on the calls listed in `bad`."""

    def __init__(self, cfg, bad):
        self.cfg, self.bad, self.calls = cfg, set(bad), 0

    def __call__(self, p, batch, rng):
        loss, m = trs.dlrm_loss(p, batch, self.cfg)
        self.calls += 1
        if self.calls in self.bad:
            loss = loss * float("nan")
        return loss, m


def test_run_retries_then_skips_nonfinite_loss():
    """Calls 3 and 4 (step 2, then its retry) are NaN: step 2 is skipped
    with the state before it; call 6 (step 4) is NaN once: the retry
    lands it.  Equal to the reference loop over the same batches with
    step 2's batch poisoned (NaN labels on both attempts)."""
    jc, jstep, _, jstate0, _ = _dlrm_setup(1)
    tc_ = trs.DLRMConfig(**dataclasses.asdict(jc))
    ocfg = topt.OptimizerConfig(peak_lr=2e-3, warmup_steps=2, decay_steps=5)
    flaky = _Flaky(tc_, bad={3, 4, 6})
    tinit, tstep = tloop.make_train_step(flaky, ocfg)
    tstate = convert.train_state_from_numpy(_state_np(jstate0), "cpu")
    logs = []
    tstate = tloop.run(tstate, tstep,
                       ((s, {k: _t(v) for k, v in b.items()})
                        for s, b in _batches(jc, 6, 1)),
                       n_steps=6, log_every=1, log_fn=logs.append)
    assert flaky.calls == 8
    assert "[loop] step 2: non-finite loss twice, skipping" in logs
    jb = []
    for s, b in _batches(jc, 6, 1):
        if s == 2:
            b = dict(b, label=np.full_like(b["label"], np.nan))
        jb.append((s, {k: jnp.asarray(v) for k, v in b.items()}))
    jlogs = []
    jstate = jloop.run(jstate0, jstep, iter(jb), n_steps=6, log_every=1,
                       log_fn=jlogs.append)
    # the log line keeps the first attempt's loss, as the reference's does
    tlines = [ln.split(" (")[0] for ln in logs if "steps/s" in ln]
    jlines = [ln.split(" (")[0] for ln in jlogs if "steps/s" in ln]
    assert tlines[3] == "[loop] step 4 loss nan"
    assert tlines[:3] + tlines[4:] == jlines[:3] + jlines[4:]
    _same_state(tstate, jstate)


def test_nonfinite_step_leaves_state_untouched():
    jc, jstep, _, jstate0, _ = _dlrm_setup(1)
    tc_ = trs.DLRMConfig(**dataclasses.asdict(jc))
    _, tstep = tloop.make_train_step(_Flaky(tc_, bad={1}),
                                     topt.OptimizerConfig())
    tstate = convert.train_state_from_numpy(_state_np(jstate0), "cpu")
    before = tckpt.to_host(tstate.tree())
    _, b = next(_batches(jc, 1, 1))
    new, m = tstep(tstate, {k: _t(v) for k, v in b.items()})
    assert not math.isfinite(float(m["loss"])) and int(new.step) == 1
    after = tckpt.flatten(tckpt.to_host(tstate.tree()))
    for k, v in tckpt.flatten(before).items():
        np.testing.assert_array_equal(after[k], v)


def test_run_resumes_from_a_jax_loop_checkpoint(tmp_path):
    """The JAX loop trains 6 steps, checkpointing at 3 and 6; the port
    loop, started from a fresh state, restores step 6 and trains on to 8
    beside the reference doing the same."""
    jc, jstep, tstep, jstate0, _ = _dlrm_setup(1)
    root = str(tmp_path / "ck")
    jbatches = [(s, {k: jnp.asarray(v) for k, v in b.items()})
                for s, b in _batches(jc, 8, 1)]
    tbatches = [(s, {k: _t(v) for k, v in b.items()})
                for s, b in _batches(jc, 8, 1)]
    jstate6 = jloop.run(jstate0, jstep, iter(jbatches), n_steps=6,
                        ckpt_dir=root, ckpt_every=3, log_every=0)
    assert jckpt.latest_step(root) == 6
    fresh = convert.train_state_from_numpy(_state_np(jstate0), "cpu")
    logs = []
    t6 = tloop.run(fresh, tstep, iter(tbatches), n_steps=6, ckpt_dir=root,
                   log_every=0, log_fn=logs.append)
    assert logs == ["[loop] restored checkpoint at step 6"]
    _same_state(t6, jstate6, tol=0.0)
    t8 = tloop.run(t6, tstep, iter(tbatches), n_steps=8, log_every=0)
    j8 = jloop.run(jstate6, jstep, iter(jbatches), n_steps=8, log_every=0)
    _same_state(t8, j8)


def test_run_writes_checkpoints_the_port_restores(tmp_path):
    jc, _, tstep, jstate0, _ = _dlrm_setup(1)
    root = str(tmp_path / "ck")
    tb = [(s, {k: _t(v) for k, v in b.items()})
          for s, b in _batches(jc, 4, 1)]
    t4 = tloop.run(convert.train_state_from_numpy(_state_np(jstate0), "cpu"),
                   tstep, iter(tb), n_steps=4, ckpt_dir=root, ckpt_every=2,
                   log_every=0)
    assert tckpt.latest_step(root) == 4
    again = tloop.run(
        convert.train_state_from_numpy(_state_np(jstate0), "cpu"), tstep,
        iter(tb), n_steps=4, ckpt_dir=root, log_every=0)
    a = tckpt.flatten(tckpt.to_host(t4.tree()))
    b = tckpt.flatten(tckpt.to_host(again.tree()))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# the example
# --------------------------------------------------------------------------

def test_recsys_admission_example_matches_reference(capsys):
    args = ["--steps", "8", "--batch", "256"]
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "recsys_admission.py"),
         *args], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    want = out.stdout.splitlines()
    cfg = jrs.DLRMConfig(**dataclasses.asdict(recsys_admission_torch.CFG))
    p0 = jax.tree_util.tree_map(
        np.asarray, jparams.init_tree(jrs.dlrm_specs(cfg),
                                      jax.random.PRNGKey(0)))
    got = recsys_admission_torch.main(args + ["--device", "cpu"],
                                      params0=p0)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(want) == 5
    assert lines[3:] == want[3:]   # the sketch counts and the table line
    assert got["table_line"] == want[4]
    for line, policy in zip(want[:2], recsys_admission_torch.POLICIES):
        m = re.fullmatch(rf"{policy}\s+final BCE \(last-10 mean\) = "
                         r"([0-9.]+)", line)
        assert m, line
        assert abs(got["bce"][policy] - float(m.group(1))) <= 5e-5 + 1e-6
    assert len(got["losses"]["admission"]) == 8
