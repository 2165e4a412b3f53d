"""Logical-axis sharding rules, the parts the routed code needs.

Counterpart of `repro/sharding.py`.  Every parameter and activation
declares *logical* axes ("embed", "heads", "batch", ...).  A rules table
maps logical axes to mesh axes per architecture family; changing a
sharding strategy is a rules edit, not a model edit.

Defaults (single-pod mesh ("data", "model"), multi-pod adds "pod"):

  batch/tokens        -> ("pod", "data")   data parallel
  embed (weights)     -> "data"            ZeRO/FSDP-style param sharding
  heads/kv/mlp/experts-> "model"           tensor/expert parallel
  vocab/table_rows    -> "model"           output + embedding sharding
  act_embed           -> "model"           saved-activation sharding
  act_seq             -> "model"           sequence parallel (residual stream)
  kv_seq              -> "data"            long-context decode KV sharding

The GSPMD half runs on DTensor.  `sharding_for` turns a logical-axes
tuple into the placements of a `DeviceMesh` (`launch/mesh.make_host_mesh`,
`make_production_mesh`); `constrain` is the reference's
`with_sharding_constraint`: inside `use_rules` it redistributes a DTensor
to the placements of its logical axes, and it leaves a plain tensor (and
everything outside `use_rules`) as it is.  The routed half reads the same
context (`transformer._moe_shardmap`).  `spec_for` also takes a mapping
{mesh axis name: size} in place of a mesh.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

Rules = dict  # logical axis name -> mesh axis | tuple of mesh axes | None

LM_RULES: Rules = {
    "batch": ("pod", "data"),
    "act_seq": "model",      # sequence-parallel residual stream
    "act_embed": None,
    "embed": "data",         # FSDP axis for weights
    "heads": "model",
    "kv_heads": "model",     # packed weight dim (n_kv * d_head)
    "mlp": "model",
    "expert_mlp": None,      # per-expert ff dim: EP only, no nested TP
    "experts": "model",
    "vocab": "model",
    "kv_seq": None,
    "cache_heads": None,     # head-count dim of the KV cache (often tiny)
    "layers": None,
}

# decode: the KV cache is the working set -- shard its sequence dim over the
# model axis (flash-decoding-style split-S); batch stays on data
LM_DECODE_RULES: Rules = dict(LM_RULES, act_seq=None, kv_seq="model")
# batch=1 long-context decode: nothing to data-shard except the KV sequence
LM_LONGCTX_RULES: Rules = dict(LM_RULES, batch=None, act_seq=None,
                               kv_seq=("pod", "data", "model"))

RECSYS_RULES: Rules = {
    "batch": ("pod", "data"),
    "table_rows": "model",
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "candidates": ("pod", "data"),
    "layers": None,
    "act_embed": None,
    "act_seq": None,
}

GNN_RULES: Rules = {
    # graphs parallelize over edges; d_hidden=128 is too small to split
    "edges": ("pod", "data", "model"),
    "nodes": None,
    "triplets": ("pod", "data", "model"),
    "batch": ("pod", "data"),
    "embed": None,
    "mlp": None,
    "layers": None,
}

_state = threading.local()


def mesh_shape(mesh) -> dict:
    """{mesh axis name: size} of a DeviceMesh or of such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(names)}


def spec_for(axes: Optional[tuple], rules: Rules, mesh,
             shape: Optional[tuple] = None) -> tuple:
    """Logical axes tuple -> one entry per dimension: a tuple of mesh axis
    names, or None (replicated); the reference's PartitionSpec entries.

    Drops mesh axes absent from `mesh`; with `shape` given, also drops mesh
    axes a dimension cannot divide evenly (longest divisible prefix), so
    e.g. a (256, 1) weight or a 50-dim head projection degrades gracefully
    to replication.
    """
    if axes is None:
        return ()
    sizes = mesh_shape(mesh)
    out = []
    for i, ax in enumerate(axes):
        target = rules.get(ax) if ax is not None else None
        if target is None:
            out.append(None)
            continue
        names = (target,) if isinstance(target, str) else tuple(target)
        names = tuple(n for n in names if n in sizes)
        if shape is not None:
            while names:
                factor = 1
                for n in names:
                    factor *= sizes[n]
                if shape[i] % factor == 0:
                    break
                names = names[:-1]
        out.append(names if names else None)
    return tuple(out)


def sharding_for(axes, rules: Rules, mesh, shape: Optional[tuple] = None
                 ) -> tuple:
    """The DTensor placements of `spec_for(axes, rules, mesh, shape)` on
    `mesh`, one per mesh dimension: `Shard(i)` where tensor dimension i
    names that mesh axis, `Replicate()` elsewhere.  A dimension split
    over several mesh axes (("pod", "data")) is `Shard(i)` on each, in
    the mesh's dimension order: the first named axis is the major one,
    as in the reference's `PartitionSpec`."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec_for(axes, rules, mesh, shape)):
        if entry is None:
            continue
        dims = [names.index(n) for n in entry]
        if dims != sorted(dims):
            raise ValueError(f"mesh axes {entry} of dimension {i} are not in "
                             f"the mesh's order {names}")
        for d in dims:
            if out[d].is_shard():  # as the reference's NamedSharding
                raise ValueError(f"mesh axis {names[d]!r} shards two "
                                 f"dimensions of {tuple(axes)}")
            out[d] = Shard(i)
    return tuple(out)


@contextlib.contextmanager
def use_rules(rules: Rules, mesh):
    """Make (rules, mesh) visible to model code (`current_ctx`,
    `constrain`).  On a `DeviceMesh`, plain tensors that meet DTensors
    (positions, masks, constants) count as replicated, as GSPMD treats
    an unsharded value."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (rules, mesh)
    try:
        if hasattr(mesh, "mesh_dim_names"):
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _state.ctx = prev


def current_ctx():
    """(rules, mesh) made active by use_rules, or None."""
    return getattr(_state, "ctx", None)


def contiguous_stride(shape) -> tuple:
    """The row-major strides of `shape`."""
    out, acc = [], 1
    for d in reversed(tuple(shape)):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def from_local(local, mesh, placements, shape):
    """`DTensor.from_local` of a contiguous local shard with the global
    `shape` given (no check, no communication)."""
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def distribute(x, mesh, placements):
    """`x` (the same whole tensor on every rank) as a DTensor with
    `placements`: each rank keeps its own shard (torch.chunk's split, the
    major mesh dim first), and no data moves between ranks:
    `distribute_tensor` without its broadcast from rank 0."""
    local = x
    coord = mesh.get_coordinate()
    for d, p in enumerate(placements):
        if p.is_shard():
            local = torch.chunk(local, mesh.size(d), dim=p.dim)[coord[d]]
    return from_local(local.contiguous(), mesh, placements, x.shape)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def chunk_range(size: int, mesh, dims) -> tuple:
    """(offset, length) of this rank's piece of a dimension of `size`
    split over the mesh dims `dims` (the major first), by torch.chunk's
    rule, as DTensor splits it."""
    lo, coord = 0, mesh.get_coordinate()
    for d in dims:
        chunk = -(-size // mesh.size(d))
        lo += coord[d] * chunk
        size = max(0, min(chunk, size - coord[d] * chunk))
    return lo, size


def replicated(x, mesh):
    """A plain tensor (the same on every rank) as a replicated DTensor;
    a DTensor as it is."""
    if is_dtensor(x):
        return x
    return from_local(x, mesh, [Replicate()] * mesh.ndim, x.shape)


def _plain(placements) -> bool:
    """No strided shard among `placements` (a merge of a sharded dim with
    its neighbours makes one; few ops have a strategy for it)."""
    return all(type(p) in (Shard, Replicate) or p.is_partial()
               for p in placements)


def _reshape_dtensor(x, shape):
    try:
        y = x.reshape(shape)
        if _plain(y.placements):
            return y
    except RuntimeError:  # no even split: nothing was communicated yet
        pass

    keep = 0
    while keep < min(len(shape), x.ndim) and shape[keep] == x.shape[keep]:
        keep += 1
    placements = [Replicate() if isinstance(p, Shard) and p.dim >= keep
                  else p for p in x.placements]
    return x.redistribute(x.device_mesh, placements).reshape(shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dtensor(g, ctx.shape), None


def reshape(x, *shape):
    """`x.reshape(*shape)`.  Where a DTensor's sharded dimension cannot be
    split or merged evenly (14 heads packed into 896 columns sharded 16
    ways), the mesh dimensions sharding the dimensions that change are
    replicated first, in the forward and in the backward: the reshard
    GSPMD inserts for the same program."""
    if not is_dtensor(x):
        return x.reshape(*shape)

    shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(
        shape[0], int) else shape
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        shape = tuple(x.numel() // known if d == -1 else d for d in shape)
    target = tuple(shape)
    return _Reshape.apply(x, target)


def matmul(a, b):
    """`a @ b`.  A DTensor `a` sharded on a dimension between its first
    and its last (a (B, S, D) activation sharded on S: sequence
    parallelism) is gathered on that dimension first, as Megatron's
    sequence parallelism gathers before a matrix product; autograd
    carries the reshard into the backward (a reduce-scatter).  Folding
    a sequence-sharded activation instead makes a strided shard, which
    the backward's products have no strategy for."""
    if not is_dtensor(a):
        return a @ b
    y = gather_inner(a) @ b
    if y.ndim > 2:  # and its gradient, which may come back sequence-sharded
        y = _GatherGrad.apply(y)
    return y


def gather_inner(x):
    """A DTensor `x` with every shard of a dimension between its first and
    its last (and every strided shard) replicated; anything else as it
    is."""
    if not is_dtensor(x):
        return x

    pl = [Replicate() if isinstance(p, Shard) and (
        0 < p.dim < x.ndim - 1 or type(p) is not Shard) else p
        for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


class _GatherGrad(torch.autograd.Function):
    """Identity; the backward gathers its gradient's inner dims."""
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_inner(g)


def _einsum_letter(ins, per_op):
    """The one letter the operands shard on one mesh dim, "" when none
    does, None when they shard on several or hold a partial sum or a
    strided shard."""
    if any(type(p) not in (Shard, Replicate) for p in per_op):
        return None
    letters = {spec[p.dim] for spec, p in zip(ins, per_op)
               if type(p) is Shard}
    return letters.pop() if len(letters) == 1 else ("" if not letters
                                                      else None)


def _einsum_placements(ins, outs, placements, sizes, mesh):
    """Output placements of an einsum run shard by shard, or None: on
    each mesh dim the operands holding one letter are sharded on it,
    evenly, the others replicated, and the output keeps the letter (a
    shard of it) or sums over it (a partial sum)."""
    out, parts = [], {}
    for d, per_op in enumerate(zip(*placements)):
        c = _einsum_letter(ins, per_op)
        if c == "":
            out.append(Replicate())
            continue
        if c is None or any(
                (c in spec) != (type(p) is Shard) or (
                    c in spec and spec[p.dim] != c)
                for spec, p in zip(ins, per_op)):
            return None
        parts[c] = parts.get(c, 1) * mesh.size(d)
        if sizes[c] % parts[c]:
            return None
        out.append(Shard(outs.index(c)) if c in outs else Partial("sum"))
    return out


def einsum(eq: str, *ops):
    """`torch.einsum(eq, *ops)`.  DTensor operands run shard by shard with
    no communication, as `local_map` would, when on each mesh dim the
    operands holding one letter are sharded on it and the others
    replicated (batch and head letters of attention, or a contracted
    letter: a partial sum).  Otherwise each mesh dim is first brought to
    that form: a replicated operand is sliced on the letter (no
    communication), one sharded elsewhere is resharded, and a mesh dim
    with several sharded letters (or pending sums) is replicated.
    DTensor's own einsum is not used: on a batch sharded over two mesh
    dims its backward views a gradient shard into the wrong shape."""
    if not any(is_dtensor(o) for o in ops):
        return torch.einsum(eq, *ops)
    ins, outs = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = next(o for o in ops if is_dtensor(o)).device_mesh
    ops = [replicated(o, mesh) for o in ops]
    sizes = {c: n for spec, o in zip(ins, ops) for c, n in zip(spec, o.shape)}
    pl = _einsum_placements(ins, outs, [o.placements for o in ops], sizes,
                            mesh)
    if pl is None:
        want = [[] for _ in ops]
        for d, per_op in enumerate(zip(*(o.placements for o in ops))):
            c = _einsum_letter(ins, per_op)
            for i, spec in enumerate(ins):
                want[i].append(Shard(spec.index(c)) if c and c in spec
                               else Replicate())
        ops = [o.redistribute(mesh, w) for o, w in zip(ops, want)]
        pl = _einsum_placements(ins, outs, [o.placements for o in ops], sizes,
                                mesh)
        if pl is None:  # uneven shards: the einsum on whole operands
            ops = [o.redistribute(mesh, [Replicate()] * mesh.ndim)
                   for o in ops]
            pl = [Replicate()] * mesh.ndim
    # contiguous: the global strides a DTensor declares are row-major
    local = torch.einsum(eq, *(o.to_local() for o in ops)).contiguous()
    return from_local(local, mesh, pl, tuple(sizes[c] for c in outs))


def update_slice(buf, upd, start, dim: int):
    """`jax.lax.dynamic_update_slice` of `upd` into `buf` along `dim` at the
    0-dim device tensor `start`, clamped to [0, len - size], out of place:
    an `index_copy` on device indices (no host synchronize).

    A DTensor `buf` is written shard by shard.  `upd` is brought to
    `buf`'s placements, whole along `dim`; each rank then copies into its
    own chunk of `dim` the updated slots that fall in it.  An update no
    longer than the chunk sends every other row of `upd` to slot (offset
    mod chunk length), rewritten with its own value (those slots are
    distinct); a longer one gathers, for each slot of the chunk, the row
    of `upd` that lands there, or keeps the slot."""
    size, n = upd.shape[dim], buf.shape[dim]
    st = torch.clamp(start.to(torch.int64), 0, n - size)
    if not is_dtensor(buf):
        idx = st + torch.arange(size, dtype=torch.int64, device=buf.device)
        return buf.index_copy(dim, idx, upd.to(buf.dtype))

    mesh = buf.device_mesh
    dims = [d for d, p in enumerate(buf.placements) if p.is_shard(dim)]
    lo, length = chunk_range(n, mesh, dims)
    want = [Replicate() if d in dims else p
            for d, p in enumerate(buf.placements)]
    upd = replicated(upd, mesh).redistribute(mesh, want).to_local()
    local = buf.to_local()
    shape = [-1 if i == dim else 1 for i in range(local.ndim)]
    if length and size > length:
        src = lo - st + torch.arange(length, dtype=torch.int64,
                                     device=local.device)
        hit = ((src >= 0) & (src < size)).reshape(shape)
        rows = upd.to(local.dtype).index_select(dim, src.clamp(0, size - 1))
        local = torch.where(hit, rows, local)
    elif length:
        k = st + torch.arange(size, dtype=torch.int64,
                              device=local.device) - lo
        slot = torch.remainder(k, length)
        mine = ((k >= 0) & (k < length)).reshape(shape)
        local = local.index_copy(dim, slot, torch.where(
            mine, upd.to(local.dtype), local.index_select(dim, slot)))
    return from_local(local, mesh, buf.placements, buf.shape)


def scale_rows(x, w):
    """`x * w[:, None]` for a 1-D `w` (a mask over `x`'s rows).  With
    DTensors, `w` is brought to `x`'s row placements (sharded where `x`'s
    rows are, replicated elsewhere) and the local shards are multiplied:
    no other communication."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x * w[:, None]

    mesh = (x if is_dtensor(x) else w).device_mesh
    x = replicated(x, mesh)
    pl = [p if p.is_shard(0) else Replicate() for p in x.placements]
    w = replicated(w, mesh).redistribute(mesh, pl)
    local = x.to_local() * w.to_local()[:, None]
    return from_local(local, mesh, x.placements, x.shape)


def take(src, idx):
    """`src.index_select(0, idx)` for a 1-D `idx`.  With DTensors each
    rank gathers the rows its own indices name from the whole `src`
    (replicated first where it is sharded), with no other communication:
    the output takes the indices' placements, and the backward's scatter
    is a partial sum over the mesh dims sharding the indices."""
    if not (is_dtensor(src) or is_dtensor(idx)):
        return src.index_select(0, idx)

    mesh = (src if is_dtensor(src) else idx).device_mesh
    pl = [p if p.is_shard(0) else Replicate()
          for p in replicated(idx, mesh).placements]
    idx = replicated(idx, mesh).redistribute(mesh, pl)
    src = replicated(src, mesh).redistribute(mesh, [Replicate()] * mesh.ndim)
    grad_pl = [Partial("sum") if p.is_shard() else Replicate() for p in pl]
    local = src.to_local(grad_placements=grad_pl).index_select(
        0, idx.to_local())
    return from_local(local, mesh, pl, (idx.shape[0],) + tuple(src.shape[1:]))


def segment_sum(x, seg, n: int):
    """`jax.ops.segment_sum(x, seg, num_segments=n)`: one `index_add` on
    zeros (in index order on the CPU, atomics on CUDA).  With DTensors
    each rank adds its own rows (`x` and `seg` sharded alike on dim 0):
    a partial sum over the mesh dims sharding them."""
    if not (is_dtensor(x) or is_dtensor(seg)):
        return x.new_zeros((n,) + x.shape[1:]).index_add(0, seg, x)

    mesh = (x if is_dtensor(x) else seg).device_mesh
    pl = [p if p.is_shard(0) else Replicate()
          for p in replicated(seg, mesh).placements]
    seg = replicated(seg, mesh).redistribute(mesh, pl)
    x = replicated(x, mesh).redistribute(mesh, pl).to_local()
    local = x.new_zeros((n,) + x.shape[1:]).index_add(0, seg.to_local(), x)
    return from_local(local, mesh, [Partial("sum") if p.is_shard() else
                                    Replicate() for p in pl],
                      (n,) + tuple(local.shape[1:]))


def constrain(x, *axes):
    """The reference's `with_sharding_constraint` through logical axes:
    inside `use_rules`, a DTensor redistributed to `sharding_for(axes)`;
    a plain tensor, or any tensor outside `use_rules`, as it is."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or not isinstance(x, DTensor):
        return x
    rules, mesh = ctx
    placements = sharding_for(tuple(axes), rules, mesh, tuple(x.shape))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
