"""Per-device statistics of a step as the port runs it.

Counterpart of `repro/roofline/hlo_stats.py`.  The reference walks the
optimized HLO of a compiled step; the port runs the step itself, once,
eagerly, on fake tensors (`FakeTensorMode`: shapes and dtypes, no
storage) and counts each op that rank 0 executes on its LOCAL shards:

  * FLOPs: `torch.utils.flop_counter`'s formulas (matrix products,
    convolutions, attention) on the local operands.  `FlopCounterMode`
    itself sits above DTensor and would count a sharded matmul at its
    global size; here the count sits below it, in the fake mode that
    every local op passes through.  A replicated op counts in full on
    every device.  `flops_16` is the part whose operands are 16-bit
    floats (charged at the tensor-core peak).
  * bytes: each op's operand and output bytes (only the output of a
    fill or a `*_like` factory).  Eager torch fuses nothing, so every
    intermediate goes to memory and back: this counts more than XLA's
    fused model, and that is what eager torch moves.  A gather (an
    embedding lookup, `index_select`, `gather`, indexing) reads the rows
    it picks, not its whole table, and an in-place scatter reads and
    writes the rows it touches: these count their indices, their other
    operands, those rows (at most the table once) and their outputs.
    Views, aliases and metadata queries move nothing and count nothing.
  * wire bytes: every collective, DTensor's redistributions and the
    routed code's explicit `all_to_all_single` / `all_gather_into_tensor`
    alike, by kind with the reference's ring models
    (`analyze.wire_bytes`), split by whether the group lies within one
    host.
  * peak memory: the live bytes of local storages, each counted once
    from the op that made it until its last tensor is freed.

Eager torch runs every loop iteration as its own ops, so no loop-trip
multiplier is needed.  While counting, DTensor's shard-to-shard
redistribution runs as the all-to-all it is on NCCL (its CPU fallback,
an all-gather and a chunk, would count 16x the bytes on a "model" group
of 16).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analyze import wire_bytes, within_host

_16BIT = (torch.bfloat16, torch.float16)

# op -> (collective kind, which tensors give its size, size from them)
_COLL = {
    "_c10d_functional::all_reduce": ("all-reduce", "in", 1),
    "_c10d_functional::all_reduce_": ("all-reduce", "in", 1),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", "in", 1),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "out", 1),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", "out", 1),
    "_c10d_functional::all_gather_into_tensor_coalesced":
        ("all-gather", "out", 1),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "out", 1),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", "out", 1),
    "_c10d_functional::all_to_all_single": ("all-to-all", "out", 1),
    "_c10d_functional::broadcast": ("collective-permute", "in", 1),
    "_dtensor::shard_dim_alltoall": ("all-to-all", "in", 1),
    "c10d::allreduce_": ("all-reduce", "in", 1),
    "c10d::_allgather_base_": ("all-gather", "arg0", 1),
    "c10d::allgather_": ("all-gather", "arg0", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", "arg0", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", "arg0", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", "arg0", 1),
    "c10d::alltoall_base_": ("all-to-all", "arg0", 1),
    "c10d::alltoall_": ("all-to-all", "arg0", 1),
    "c10d::broadcast_": ("collective-permute", "in", 1),
}
# ops that move no data: allocation, metadata, aliases not flagged as views
_SKIP = ("_c10d_functional::wait_tensor", "aten::empty", "aten::empty_like",
         "aten::empty_strided", "aten::_local_scalar_dense",
         "aten::lift_fresh", "aten::set_", "aten::_unsafe_view",
         "aten::alias", "aten::detach")
# ops that write their output and read no operand's data (only its shape)
_WRITE_ONLY = ("aten::zero_", "aten::fill_", "aten::new_zeros",
               "aten::new_ones", "aten::new_full", "aten::new_empty",
               "aten::zeros_like", "aten::ones_like", "aten::full_like",
               "aten::empty_like")


# gathers: (source, dimension it is indexed on, index); None = elementwise
_GATHER = {
    "aten::embedding": lambda a: (a[0], 0, a[1]),
    "aten::_embedding_bag": lambda a: (a[0], 0, a[1]),
    "aten::_embedding_bag_forward_only": lambda a: (a[0], 0, a[1]),
    "aten::index_select": lambda a: (a[0], a[1], a[2]),
    "aten::gather": None, "aten::take": None, "aten::index": None,
}
# in-place scatters: (destination, dimension, index, read-modify-write)
_SCATTER = {
    "aten::index_add_": lambda a: (a[0], a[1], a[2], True),
    "aten::index_copy_": lambda a: (a[0], a[1], a[2], False),
    "aten::scatter_add_": lambda a: (a[0], None, a[2], True),
    "aten::scatter_": lambda a: (a[0], None, a[2], False),
    "aten::index_put_": lambda a: (a[0], "put", a[1], bool(
        a[3] if len(a) > 3 else False)),
    "aten::_index_put_impl_": lambda a: (a[0], "put", a[1], bool(
        a[3] if len(a) > 3 else False)),
}


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    flops_16: float = 0.0
    bytes: float = 0.0
    wire_intra: float = 0.0      # groups within one host (NVLink)
    wire_inter: float = 0.0      # groups across hosts
    wire_by_op: dict = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    n_ops: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0


def nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _rows(table, dim, idx) -> int:
    """Bytes of the slices of `table` along `dim` that `idx` names (one
    per index), or of `idx.numel()` elements (dim None), at most the
    whole table once."""
    if dim is None:
        return min(nbytes(table), idx.numel() * table.element_size())
    n = table.shape[dim] if table.dim() else 1
    return min(nbytes(table), idx.numel() * nbytes(table) // max(n, 1))


def _put_rows(table, indices) -> int:
    """Bytes of `table[indices]` (advanced indexing on leading dims)."""
    idx = [i for i in indices if i is not None]
    if not idx:
        return nbytes(table)
    lead = torch.broadcast_shapes(*(i.shape for i in idx)).numel()
    rest = table.shape[len(indices):].numel()
    return min(nbytes(table), lead * rest * table.element_size())


def _indexed_bytes(name, args, ins, outs):
    """Bytes a gather or an in-place scatter moves (see the module
    docstring); None for any other op."""
    if name in _GATHER:
        table = args[0]
        rest = sum(map(nbytes, ins)) - nbytes(table)
        how = _GATHER[name]
        read = (nbytes(outs[0]) if how is None
                else _rows(*how(args)))
        return rest + min(read, nbytes(table)) + sum(map(nbytes, outs))
    if name in _SCATTER:
        table, dim, idx, rmw = _SCATTER[name](args)
        rest = sum(map(nbytes, ins)) - nbytes(table)
        touched = (_put_rows(table, idx) if dim == "put"
                   else _rows(table, dim, idx))
        return rest + touched * (2 if rmw else 1)
    return None


def _group_ranks(args):
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(_resolve_process_group(a))
            except (ValueError, RuntimeError, KeyError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    return None


def tensors(x) -> list:
    """The tensor leaves of a pytree."""
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class _CountingMode(FakeTensorMode):
    """A `FakeTensorMode` that counts the ops it runs on fake tensors.
    DTensor ops reach it once as NotImplemented (not counted) and then
    as the local ops DTensor runs on each shard (counted); ops nested
    inside a counted op (decompositions) are not counted again."""

    def __init__(self, stats: OpStats):
        super().__init__(allow_non_fake_inputs=True,
                         allow_fallback_kernels=False)
        self.stats = stats
        self._depth = 0
        self._storages: dict = {}

    def _track(self, t) -> None:
        if not isinstance(t, FakeTensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [st.nbytes(), 0]
            self.stats.live_bytes += entry[0]
            self.stats.peak_bytes = max(self.stats.peak_bytes,
                                        self.stats.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.stats.live_bytes -= entry[0]
            del self._storages[key]

    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._depth or any(issubclass(t, DTensor) for t in types):
            return super().dispatch(func, types, args, kwargs)
        self._depth += 1
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is NotImplemented:
            return out
        self._count(func, args, kwargs, out)
        ins = {id(t) for t in tensors((args, kwargs))}
        for t in tensors(out):
            if id(t) not in ins:
                self._track(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        s = self.stats
        if name in _SKIP or func.is_view or name.startswith("prim::"):
            return
        s.n_ops += 1
        ins = tensors((args, kwargs))
        outs = tensors(out)
        if name in _COLL:
            kind, src, _ = _COLL[name]
            size = sum(map(nbytes, {"in": ins, "out": outs,
                                     "arg0": tensors(args[0])}[src]))
            ranks = _group_ranks(list(args) + list(kwargs.values()))
            n = len(ranks) if ranks else 1
            wire = wire_bytes(kind, size, n)
            if ranks is None or within_host(ranks):
                s.wire_intra += wire
            else:
                s.wire_inter += wire
            s.wire_by_op[kind] = s.wire_by_op.get(kind, 0.0) + wire
            s.n_collectives += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            s.flops += f
            if ins and ins[0].dtype in _16BIT:
                s.flops_16 += f
        indexed = _indexed_bytes(name, args, ins, outs)
        if indexed is not None:
            s.bytes += indexed
            return
        if name not in _WRITE_ONLY:
            s.bytes += sum(map(nbytes, ins))
        s.bytes += sum(map(nbytes, outs))


@contextlib.contextmanager
def _alltoall_as_on_nccl():
    """DTensor's shard-to-shard redistribution as the all-to-all op, on
    any device type (see the module docstring)."""
    import importlib

    from torch.distributed.tensor import _collective_utils as cu

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    mods = [cu, importlib.import_module(
        "torch.distributed.tensor.placement_types")]
    saved = [(m, m.shard_dim_alltoall) for m in mods
             if hasattr(m, "shard_dim_alltoall")]
    if not saved or not hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        raise RuntimeError(
            "this torch has no DTensor `shard_dim_alltoall`: a shard-to-shard "
            "redistribution would be counted as an all-gather")
    for m, _ in saved:
        m.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        for m, f in saved:
            m.shard_dim_alltoall = f


@contextlib.contextmanager
def _uncounted_propagation(mode: _CountingMode):
    """DTensor infers an op's output shape by running it once at the
    GLOBAL shapes in the active fake mode; those runs are not the
    device's work and are not counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError("this torch's ShardingPropagator has no shape "
                           "propagation method to leave uncounted")
    orig = getattr(ShardingPropagator, name)

    def wrapped(self, *args, **kwargs):
        mode._depth += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            mode._depth -= 1

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def counting():
    """Count what runs inside: yields the `OpStats` it fills.  Tensors
    made inside are fake (device "cpu" unless a mesh says otherwise) and
    allocate nothing."""
    stats = OpStats()
    mode = _CountingMode(stats)
    with _alltoall_as_on_nccl(), _uncounted_propagation(mode), mode:
        yield stats


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor leaf of `tree`."""
    total = 0
    for t in tensors(tree):
        total += nbytes(getattr(t, "_local_tensor", t))
    return total
