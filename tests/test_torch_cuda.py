"""The CUDA kernels against their plain versions, on the card (small sizes).

Marked `cuda`: these need a GPU and the CUDA toolkit, skip elsewhere, and
run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every kernel must land exactly what its plain PyTorch version lands on
the same device: equal cell states, ring cells and float32 estimates
(the kernels are built with -fmad=false and no fast math, so each float
operation rounds as torch's own CUDA ops do).  `chip_smoke.py` repeats
the comparison at the full-size shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import counters as tc
from repro_torch.core import sketch as tsk
from repro_torch.core.counters import signed_view
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sketch as ksk
from repro_torch.stream import CountService

FORMATS = [("CMS32", False), ("CMLS16", False), ("CMLS16", True),
           ("CMLS8", False), ("CMLS8", True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _spec(name, packed, width=4096):
    return tsk.SketchSpec(width=width, depth=2, counter=getattr(tc, name),
                          packed=packed)


@pytest.mark.cuda
@pytest.mark.parametrize("name,packed", FORMATS)
def test_update_score_and_query_kernels_equal_plain(cuda, name, packed):
    spec = _spec(name, packed)
    rng = np.random.default_rng(0)
    raw = tc.from_numpy(rng.integers(0, 3000, (3, 3000)).astype(np.uint32),
                        cuda)
    w = torch.ones(raw.shape, dtype=torch.float32, device=cuda)
    skeys, mult = tsk.dedup_weighted(raw, w)
    unif = ops._parity_uniforms([1, 2], raw.shape[1], 4, [3, 0, 1], cuda)
    rows = torch.tensor([3, 0, 1], dtype=torch.int32, device=cuda)
    cand = raw[:, :500].contiguous()
    tk = tc.zeros((4, 2, spec.storage_width), spec.storage_dtype, cuda)
    tp = tk.clone()
    seeds = ops._seeds_tuple(spec)
    _, ek = ksk.fused_update_score(tk, ops.as_device_keys(skeys, cuda), mult,
                                   unif, cand, rows, seeds=seeds,
                                   width=spec.width, counter=spec.counter,
                                   cpl=spec.cells_per_lane)
    _, ep = ref.update_score_rows_ref(tp, skeys, mult, unif, rows, cand,
                                      ops._seed_tensor(spec, cuda),
                                      spec.counter, ksk.CHUNK,
                                      cpl=spec.cells_per_lane)
    assert torch.equal(signed_view(tk), signed_view(tp))
    assert torch.equal(ek, ep)
    probes = raw[0, :700]  # one probe row, broadcast to all 4 tables
    qk = ops.query_many(tk, spec, probes, engine="auto")
    qp = ops.query_many(tk, spec, probes, engine="plain")
    assert torch.equal(qk, qp)


@pytest.mark.cuda
def test_queue_appends_equal_plain(cuda):
    rng = np.random.default_rng(1)
    ring = tc.from_numpy(rng.integers(0, 2**32, (4, 2048), dtype=np.uint64)
                         .astype(np.uint32), cuda)
    keys = tc.from_numpy(rng.integers(0, 2**32, (4, 1024), dtype=np.uint64)
                         .astype(np.uint32), cuda)
    for rows, fill, count in (([0, 1, 2, 3], [0, 1024, 7, 2047],
                               [1024, 1024, 1000, 1]),
                              ([2, 0], [100, 1024], [5, 1024])):
        a, b = ring.clone(), ring.clone()
        ops.queue_append(a, keys[:len(rows)].contiguous(), rows, fill, count,
                         engine="auto")
        ops.queue_append(b, keys[:len(rows)].contiguous(), rows, fill, count,
                         engine="plain")
        assert torch.equal(signed_view(a), signed_view(b))


@pytest.mark.cuda
def test_service_auto_equals_plain_and_launches_every_kernel(cuda):
    spec = _spec("CMLS16", False)
    names = [f"t{i}" for i in range(4)]
    services = []
    ksk.reset_kernel_launches()
    for engine in ("auto", "plain"):
        svc = CountService(spec, tenants=names, queue_capacity=1024,
                           track_top=8, device=cuda, engine=engine)
        rng = np.random.default_rng(2)
        for _ in range(3):
            svc.enqueue_many({n: rng.zipf(1.3, 400).astype(np.uint32) % 999
                              for n in names})
            svc.enqueue("t1", rng.integers(0, 99, 300))
        est = svc.query_all(np.arange(64))
        services.append((svc, est))
        if engine == "auto":
            assert all(v > 0 for v in ksk.kernel_launches().values())
    (a, ea), (b, eb) = services
    assert torch.equal(signed_view(a.planes[0].tables),
                       signed_view(b.planes[0].tables))
    for n in names:
        assert torch.equal(ea[n], eb[n])
