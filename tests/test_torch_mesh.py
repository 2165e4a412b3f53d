"""The port's GSPMD placement on real DTensors: ONE spawn of 4 gloo ranks
as a 2 x 2 ("data", "model") mesh (`run`, below), against the unmeshed
port and the JAX package's unmeshed training (CPU).

  * `sharding_for` / `constrain` on real DTensors: inside `use_rules` a
    DTensor is redistributed to its logical axes' placements (each rank
    holding its chunk of the whole), a plain tensor is left as it is,
    and outside `use_rules` nothing moves;
  * three steps of `launch.train --mesh --model 2` (the qwen2 smoke
    config on the corpus vocabulary, the reference's init carried
    across) against `launch.train` unmeshed and the reference's
    `make_train_step` over the same batches: losses within 1e-5
    relative, parameters within 1e-4 normwise;
  * `launch.serve --mesh --model 2`: the unmeshed port's greedy tokens;
  * a checkpoint saved on the 2 x 2 mesh restored onto a (4, 1) mesh and
    onto one unmeshed process, and a JAX-written checkpoint restored
    onto the 2 x 2 mesh: bit for bit;
  * the training loop's own checkpoints (`--ckpt-every 1`): written once,
    by rank 0, with no error in any rank's writer thread, and resumed by
    `launch.train --mesh` bit for bit;
  * `layers.embedding_bag` of a row-sharded table in modes "sum", "mean"
    and "max", unweighted and weighted, and `sharding.update_slice` of
    an update longer than a rank's chunk (a clamped start included),
    against the reference's single-device `embedding_bag` and
    `jax.lax.dynamic_update_slice` on the whole arrays: exact (the
    inputs are small integers, the bag weights sum to 2).
"""
import dataclasses
import os
import tempfile
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import registry as jreg
from repro.data import corpus as jcorpus
from repro.data import pipeline as jpipe
from repro.models import params as jparams
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.params import flatten, unflatten
from repro_torch.train import checkpoint as tckpt

JOIN_TIMEOUT = 150.0
W, MODEL = 4, 2
STEPS, BATCH, SEQ = 3, 4, 16
TRAIN = ["--arch", "qwen2-0.5b", "--steps", str(STEPS), "--batch",
         str(BATCH), "--seq", str(SEQ), "--device", "cpu"]
SERVE = ["--batch", "2", "--prompt-len", "8", "--gen", "6", "--seed", "3",
         "--device", "cpu"]
LOSS = 1e-5
PARAMS = 1e-4


# sharded lookups and slice writes: row placements of a (10, 6) table and
# a (12, 3) buffer on the 2 x 2 mesh (rows over "data", over both dims,
# rows and columns)
BAG_PLACEMENTS = ["rows_data", "rows_both", "rows_cols"]
SLICE_PLACEMENTS = ["rows_data", "rows_both"]
SLICE_STARTS = [4, 0, 10]  # 10 clamps to 5, as dynamic_update_slice does


def _placements():
    from torch.distributed.tensor import Replicate, Shard
    return {"rows_data": [Shard(0), Replicate()],
            "rows_both": [Shard(0), Shard(0)],
            "rows_cols": [Shard(0), Shard(1)]}


PLACEMENTS = _placements()


def _slice_inputs():
    """Small-integer tables, and bag weights that sum to 2 in every bag,
    so every sum and mean is exact in float32 in any order: (table, ids,
    weights, buf, upd), upd 7 rows long, longer than any chunk of buf."""
    rng = np.random.default_rng(5)
    table = rng.integers(-8, 8, (10, 6)).astype(np.float32)
    ids = rng.integers(0, 10, (5, 4)).astype(np.int64)
    wts = np.stack([rng.permutation(np.array([1.0, 0.5, 0.25, 0.25]))
                    for _ in range(5)]).astype(np.float32)
    buf = rng.integers(-8, 8, (12, 3)).astype(np.float32)
    upd = rng.integers(20, 30, (7, 3)).astype(np.float32)
    return table, ids, wts, buf, upd


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as ttf
    from repro_torch.models.params import abstract_tree

    torch.set_num_threads(1)
    mesh_lib.init_group(world, rank, backend="gloo", init_file=init_file)
    mesh = mesh_lib.make_host_mesh(MODEL)
    res = {}

    # constrain / sharding_for on real DTensors
    whole = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    d = sharding.distribute(whole, mesh, [Replicate(), Replicate()])
    want = sharding.sharding_for(("batch", "mlp"), sharding.LM_RULES, mesh,
                                 (8, 6))
    with sharding.use_rules(sharding.LM_RULES, mesh):
        y = sharding.constrain(d, "batch", "mlp")
        res["plain_kept"] = sharding.constrain(whole, "batch") is whole
    res["outside_kept"] = sharding.constrain(d, "batch", "mlp") is d
    res["constrain_pl"] = tuple(y.placements) == want
    res["constrain_local"] = y.to_local().numpy()
    res["constrain_full"] = y.full_tensor().numpy()

    # the sharded embedding bag ("max", weighted) and an update longer
    # than a chunk, on the mesh
    from repro_torch.models import layers
    table, ids, wts, buf, upd = (torch.from_numpy(x) for x in _slice_inputs())
    for pl in BAG_PLACEMENTS:
        placed = sharding.distribute(table, mesh, PLACEMENTS[pl])
        for mode in ("sum", "mean", "max"):
            for weighted in (False, True):
                out = layers.embedding_bag(placed, ids, mode,
                                           wts if weighted else None)
                res[f"bag/{pl}/{mode}/{weighted}"] = out.full_tensor().numpy()
    for pl in SLICE_PLACEMENTS:
        placed = sharding.distribute(buf, mesh, PLACEMENTS[pl])
        for start in SLICE_STARTS:
            out = sharding.update_slice(placed, upd, torch.tensor(start), 0)
            res[f"slice/{pl}/{start}"] = out.full_tensor().numpy()

    # three steps of launch.train on the mesh, the reference's init, the
    # loop checkpointing every step
    init = dict(np.load(f"{out_dir}/init.npz"))
    rec, errors = {}, []
    threading.excepthook = lambda a: errors.append(repr(a.exc_value))
    meshed = TRAIN + ["--mesh", "--model", str(MODEL), "--ckpt-dir",
                      f"{out_dir}/loop", "--ckpt-every", "1"]
    state, _ = ttrain.main(meshed, params=unflatten(init), record=rec)
    res["losses"] = np.asarray(rec["loss"])
    full = {k: v.full_tensor() for k, v in flatten(state.params).items()}
    if rank == 0:
        res.update({f"params/{k}": v.numpy() for k, v in full.items()})

    # the loop's checkpoints: resumed at the last step, no step trained
    again, _ = ttrain.main(meshed)
    res["loop_dirs"] = np.array(sorted(os.listdir(f"{out_dir}/loop")))
    res["loop_resumed"] = int(again.step) == STEPS and all(
        torch.equal(_whole(a), _whole(b)) for a, b in zip(
            flatten([again.params, again.opt_state]).values(),
            flatten([state.params, state.opt_state]).values()))
    res["loop_errors"] = np.array(errors, dtype=str)

    # launch.serve on the mesh
    res["serve"] = tserve.main(SERVE + ["--mesh", "--model", str(MODEL)])[2] \
        .numpy()

    # checkpoints across meshes
    tckpt.save(f"{out_dir}/ck", STEPS, state.params)
    specs = ttf.param_specs(_cfg())
    mesh41 = mesh_lib.make_host_mesh(1)
    back, _ = tckpt.restore(f"{out_dir}/ck", abstract_tree(
        specs, sharding.LM_RULES, mesh41), device="cpu")
    res["ck41_mesh"] = all(v.device_mesh is mesh41
                           for v in flatten(back).values())
    res["ck41_equal"] = all(torch.equal(v.full_tensor(), full[k])
                            for k, v in flatten(back).items())
    jback, _ = tckpt.restore(f"{out_dir}/jck", abstract_tree(
        specs, sharding.LM_RULES, mesh), device="cpu")
    res["jck_equal"] = all(np.array_equal(v.full_tensor().numpy(), init[k])
                           for k, v in flatten(jback).items())
    res["jck_placed"] = all(
        tuple(v.placements) == sharding.sharding_for(
            s.axes, sharding.LM_RULES, mesh, s.shape)
        for (k, v), s in zip(flatten(jback).items(), flatten(specs).values()))
    dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **res)


def _whole(v):
    return v.full_tensor() if hasattr(v, "full_tensor") else v


def _cfg():
    """The qwen2 smoke config on the corpus vocabulary, as launch.train
    builds it (port)."""
    from repro_torch.configs import registry as treg
    from repro_torch.data import corpus as tcorpus

    return dataclasses.replace(
        treg.get("qwen2-0.5b").smoke_cfg,
        vocab_size=tcorpus.CorpusSpec(n_tokens=2_000_000).vocab_size)


def _reference(tmp):
    """The reference's init (also written as a JAX checkpoint) and three
    train steps over launch.train's batches."""
    spec = jcorpus.CorpusSpec(n_tokens=2_000_000)
    jcfg = dataclasses.replace(jreg.get("qwen2-0.5b").smoke_cfg,
                               vocab_size=spec.vocab_size)
    params = jparams.init_tree(jtf.param_specs(jcfg), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    jckpt.save(f"{tmp}/jck", 0, np_params)
    init = {k: np.asarray(v) for k, v in flatten(np_params).items()}
    np.savez(f"{tmp}/init.npz", **init)
    ocfg = jopt.OptimizerConfig(peak_lr=3e-4, warmup_steps=STEPS // 10,
                                decay_steps=STEPS)
    jinit, jstep = jloop.make_train_step(
        lambda p, b, r: jtf.loss_fn(p, {"tokens": b["tokens"],
                                        "targets": b["targets"]}, jcfg), ocfg)
    state = jinit(params, jax.random.PRNGKey(1))
    src = jpipe.token_batch_source(jcorpus.generate(spec), BATCH, SEQ, 0)
    step = jax.jit(jstep)
    losses = []
    for i in range(STEPS):
        state, m = step(state, {k: jax.numpy.asarray(v)
                                for k, v in src.batch(i, 0, 1).items()})
        losses.append(float(m["loss"]))
    return init, np.asarray(losses), {
        k: np.asarray(v) for k, v in flatten(
            jax.tree_util.tree_map(np.asarray, state.params)).items()}


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        init, jlosses, jparams_after = _reference(tmp)
        ctx = mp.start_processes(run, args=(W, f"{tmp}/store", tmp),
                                 nprocs=W, join=False, start_method="spawn")
        # the unmeshed port while the ranks run
        trec = {}
        tstate, _ = ttrain.main(TRAIN, params=unflatten(init), record=trec)
        tserved = tserve.main(SERVE)[2].numpy()
        deadline = time.monotonic() + JOIN_TIMEOUT
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"W={W} ranks still running after "
                                       f"{JOIN_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        res = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(W)]
        plain_target = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
                        flatten(tstate.params).items()}
        unmeshed, _ = tckpt.restore(f"{tmp}/ck", unflatten(plain_target),
                                    device="cpu")
        return {"ranks": res, "jlosses": jlosses, "jparams": jparams_after,
                "tlosses": np.asarray(trec["loss"]), "tparams": {
                    k: v.numpy() for k, v in flatten(tstate.params).items()},
                "served": tserved, "unmeshed": {
                    k: v.numpy() for k, v in flatten(unmeshed).items()}}


def _rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _norm_rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / max(np.linalg.norm(ref),
                                                  1e-30))


@pytest.mark.parametrize("r", range(W))
def test_constrain_places_real_dtensors(ranks, r):
    res = ranks["ranks"][r]
    assert res["constrain_pl"] and res["plain_kept"] and res["outside_kept"]
    whole = np.arange(48, dtype=np.float32).reshape(8, 6)
    data, model = divmod(r, MODEL)
    np.testing.assert_array_equal(res["constrain_full"], whole)
    np.testing.assert_array_equal(
        res["constrain_local"], whole[data * 4:(data + 1) * 4,
                                      model * 3:(model + 1) * 3])


@pytest.mark.parametrize("against", ["port", "reference"])
def test_meshed_training_losses_match(ranks, against):
    want = ranks["tlosses"] if against == "port" else ranks["jlosses"]
    for res in ranks["ranks"]:
        assert len(res["losses"]) == STEPS
        assert _rel(res["losses"], want) <= LOSS


@pytest.mark.parametrize("against", ["port", "reference"])
def test_meshed_training_params_match(ranks, against):
    want = ranks["tparams"] if against == "port" else ranks["jparams"]
    got = {k[len("params/"):]: v for k, v in ranks["ranks"][0].items()
           if k.startswith("params/")}
    assert set(got) == set(want)
    for k, v in got.items():
        assert _norm_rel(v, want[k]) <= PARAMS, k


def test_meshed_serve_matches_unmeshed(ranks):
    for res in ranks["ranks"]:
        np.testing.assert_array_equal(res["serve"], ranks["served"])


@pytest.mark.parametrize("case", ["onto_4x1", "unmeshed", "jax_written",
                                  "loop_resumed"])
def test_checkpoints_cross_meshes_bit_for_bit(ranks, case):
    if case == "onto_4x1":
        assert all(r["ck41_mesh"] and r["ck41_equal"] for r in ranks["ranks"])
    elif case == "jax_written":
        assert all(r["jck_equal"] and r["jck_placed"] for r in ranks["ranks"])
    elif case == "loop_resumed":
        want = [f"step_{s:08d}" for s in range(1, STEPS + 1)]
        for r in ranks["ranks"]:
            assert list(r["loop_dirs"]) == want
            assert r["loop_errors"].size == 0, r["loop_errors"]
            assert r["loop_resumed"]
    else:
        saved = {k[len("params/"):]: v for k, v in ranks["ranks"][0].items()
                 if k.startswith("params/")}
        assert set(saved) == set(ranks["unmeshed"])
        for k, v in saved.items():
            np.testing.assert_array_equal(ranks["unmeshed"][k], v)


@pytest.mark.parametrize("placement", BAG_PLACEMENTS)
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_sharded_embedding_bag_matches_reference(ranks, mode, placement):
    """`layers.embedding_bag` of a row-sharded DTensor table, unweighted
    and weighted, equals the reference's single-device `embedding_bag` on
    the whole table on every rank."""
    from repro.models import layers as jlayers
    table, ids, wts, _, _ = _slice_inputs()
    for weighted in (False, True):
        want = np.asarray(jlayers.embedding_bag(
            jax.numpy.asarray(table), jax.numpy.asarray(ids), mode,
            jax.numpy.asarray(wts) if weighted else None))
        for res in ranks["ranks"]:
            np.testing.assert_array_equal(
                res[f"bag/{placement}/{mode}/{weighted}"], want)


@pytest.mark.parametrize("placement", SLICE_PLACEMENTS)
def test_sharded_update_slice_longer_than_a_chunk(ranks, placement):
    """`sharding.update_slice` of a 7-row update into a (12, 3) buffer
    sharded in chunks of 6 or 3 rows equals `jax.lax.dynamic_update_slice`
    on the whole buffer, a clamped start included."""
    _, _, _, buf, upd = _slice_inputs()
    for start in SLICE_STARTS:
        want = np.asarray(jax.lax.dynamic_update_slice(
            jax.numpy.asarray(buf), jax.numpy.asarray(upd),
            (jax.numpy.int32(start), jax.numpy.int32(0))))
        for res in ranks["ranks"]:
            np.testing.assert_array_equal(res[f"slice/{placement}/{start}"],
                                          want)
