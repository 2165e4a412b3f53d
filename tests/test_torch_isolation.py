"""The port stands alone: no JAX, no `repro`, and no silent CPU fallback.

A fresh interpreter imports every `repro_torch` module, the port's
examples (`examples/*_torch.py`) and `chip_smoke.py` and must end with
neither `jax` nor `repro` (nor any `repro.*` module) loaded.  Entry points that are not given a device run
on CUDA, so where there is no GPU they raise instead of carrying on on
the CPU, and `chip_smoke.py` exits non-zero and prints no result there.
"""
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, json, pkgutil, runpy, sys
sys.path.insert(0, {src!r})
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
for path in {examples!r}:
    runpy.run_path(path, run_name="example_import_check")
runpy.run_path({smoke!r}, run_name="chip_smoke_import_check")
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({{"modules": mods, "bad": bad}}))
"""


def test_port_and_chip_smoke_import_no_jax_or_repro():
    examples = sorted(str(p) for p in (ROOT / "examples").glob("*_torch.py"))
    assert len(examples) == 5
    code = _PROBE.format(src=str(SRC), smoke=str(ROOT / "chip_smoke.py"),
                         examples=examples)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for m in ("repro_torch.stream.service", "repro_torch.stream.window",
              "repro_torch.kernels.sketch", "repro_torch.kernels.ops",
              "repro_torch.kernels.ref", "repro_torch.kernels.build",
              "repro_torch.convert", "repro_torch.launch.serve_counts",
              "repro_torch.core.prng", "repro_torch.core.sketch",
              "repro_torch.core.staging", "repro_torch.core.admission",
              "repro_torch.core.device", "repro_torch.core.sharded",
              "repro_torch.stream.tiering", "repro_torch.train.checkpoint",
              "repro_torch.core.estimators", "repro_torch.obs.probes",
              "repro_torch.obs.export", "repro_torch.core.xla_f32",
              "repro_torch.core.topk", "repro_torch.data.corpus",
              "repro_torch.data.ngrams", "repro_torch.configs.registry",
              "repro_torch.configs.paper_sketch",
              "repro_torch.launch.mesh", "repro_torch.models.params",
              "repro_torch.models.layers", "repro_torch.models.recsys",
              "repro_torch.data.recsys_stream", "repro_torch.data.pipeline",
              "repro_torch.train.optimizer", "repro_torch.train.loop",
              "repro_torch.configs.dlrm_mlperf",
              "repro_torch.configs.two_tower", "repro_torch.models.attention",
              "repro_torch.models.moe", "repro_torch.models.transformer",
              "repro_torch.launch.serve", "repro_torch.launch.train",
              "repro_torch.configs.qwen2_05b", "repro_torch.configs.phi3_mini",
              "repro_torch.configs.gemma2_27b",
              "repro_torch.configs.llama4_scout",
              "repro_torch.configs.deepseek_v2_lite",
              "repro_torch.configs.sasrec", "repro_torch.configs.bert4rec",
              "repro_torch.data.graph", "repro_torch.models.dimenet",
              "repro_torch.configs.dimenet", "repro_torch.routing",
              "repro_torch.sharding", "repro_torch.train.compression",
              "repro_torch.launch.cells", "repro_torch.launch.dryrun",
              "repro_torch.launch.hillclimb", "repro_torch.roofline.analyze",
              "repro_torch.roofline.op_stats",
              "repro_torch.roofline.report"):
        assert m in res["modules"]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA entry points run instead of "
                    "raising")


def test_entry_points_without_device_raise_without_cuda(no_cuda):
    from repro_torch.core import CMLS16, SketchSpec
    from repro_torch.launch import serve_counts
    from repro_torch.stream import (CountService, TenantPlane, TierSpec,
                                    WindowPlane, WindowSpec)
    spec = SketchSpec(width=256, counter=CMLS16)
    with pytest.raises(RuntimeError, match="CUDA"):
        CountService(spec, tenants=["a"], track_top=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TenantPlane(spec, 128, track_top=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TenantPlane(spec, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        WindowPlane(WindowSpec(sketch=spec, buckets=2, interval=1.0), 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_counts.main(["--tenants", "1", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        CountService(spec, tenants=["a"], tier=TierSpec(max_hot_tenants=1))


def test_init_tree_without_device_raises_without_cuda(no_cuda):
    """`models.params.init_tree` makes its tensors on CUDA unless asked
    for the CPU: without a GPU, no device raises."""
    from repro_torch.models import params, recsys
    specs = recsys.dlrm_specs(recsys.DLRMConfig(
        embed_dim=4, bot_mlp=(13, 4), top_mlp=(4, 1), table_sizes=(8,) * 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        params.init_tree(specs)
    with pytest.raises(RuntimeError, match="CUDA"):
        params.init_tree(specs, 0, "cuda")
    tree = params.init_tree(specs, 0, "cpu")
    assert tree["tables"]["t0"].device.type == "cpu"


def test_sketch_init_without_device_raises_without_cuda(no_cuda):
    """`core.sketch.init` runs on CUDA unless asked for the CPU: without a
    GPU, no device raises, and device="cpu" builds the sketch."""
    from repro_torch.core import CMLS16, SketchSpec, sketch
    spec = SketchSpec(width=256, counter=CMLS16)
    with pytest.raises(RuntimeError, match="CUDA"):
        sketch.init(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        sketch.init(spec, device="cuda")
    assert sketch.init(spec, device="cpu").table.device.type == "cpu"


@pytest.mark.parametrize("ctor", ["topk.init_stacked", "topk.init",
                                  "window_init", "decayed_init"])
def test_state_constructors_raise_without_cuda(ctor, no_cuda):
    """The public constructors of tracker, ring and decayed state run on
    CUDA unless asked for the CPU: without a GPU, no device raises, and
    device="cpu" builds on the CPU."""
    from repro_torch.core import CMLS16, SketchSpec, topk
    from repro_torch.stream import WindowSpec, decayed_init, window_init
    spec = SketchSpec(width=256, counter=CMLS16)
    build = {
        "topk.init_stacked": lambda **kw: topk.init_stacked(3, 4, **kw).keys,
        "topk.init": lambda **kw: topk.init(4, **kw).keys,
        "window_init": lambda **kw: window_init(
            WindowSpec(sketch=spec, buckets=2), **kw).tables,
        "decayed_init": lambda **kw: decayed_init(spec, history=2,
                                                  **kw).tables,
    }[ctor]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    with pytest.raises(RuntimeError, match="CUDA"):
        build(device="cuda")
    assert build(device="cpu").device.type == "cpu"


def test_examples_and_nccl_group_raise_without_cuda(no_cuda):
    """The port's examples run on the card unless given --device cpu, and
    a NCCL group needs CUDA: without a GPU both raise (no silent gloo)."""
    from repro_torch.launch import mesh
    sys.path.insert(0, str(ROOT / "examples"))
    import quickstart_torch
    import recsys_admission_torch
    import streaming_pmi_torch
    import trending_items_torch
    for mod in (quickstart_torch, streaming_pmi_torch, trending_items_torch,
                recsys_admission_torch):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
    with pytest.raises(RuntimeError, match="NCCL backend needs CUDA"):
        mesh.init_group()
    with pytest.raises(ValueError, match="unsupported backend"):
        mesh.init_group(backend="mpi")


def test_chip_smoke_fails_without_cuda(no_cuda):
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_lm_entry_points_without_device_raise_without_cuda(no_cuda):
    """The LM launchers and `transformer.init_cache` run on CUDA unless
    asked for the CPU: without a GPU, no device raises."""
    from repro_torch.configs import qwen2_05b
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--gen", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_cache(qwen2_05b.SMOKE, 1, 8)
    cache = transformer.init_cache(qwen2_05b.SMOKE, 1, 8, device="cpu")
    assert cache["blocks"]["l0"]["pos"].device.type == "cpu"
