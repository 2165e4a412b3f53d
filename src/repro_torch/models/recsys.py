"""RecSys model family, PyTorch: DLRM, SASRec, BERT4Rec, two-tower retrieval.

Counterpart of `repro/models/recsys.py`.
The counting plane (the paper's CMLS sketch) enters here in two places:
  * admission -- ids pass through a sketch-gated admission map before
    the embedding lookup (`core/admission.py`; the tables are then
    `n_fallback + table_rows` rows, see `examples/recsys_admission_torch`);
  * two-tower in-batch softmax applies logQ correction with sampling
    probabilities estimated from the sketch (the `item_logq` input).

Lookups are `F.embedding` / `F.embedding_bag` (the reference's `jnp.take`
and gather + reduce), the matrix products `torch.matmul` / `bmm`, and
autograd computes every gradient: no Pallas kernel sits on this path.
`sharding.constrain` sits where the reference's does; it does nothing
outside `sharding.use_rules` or on plain tensors.

The row-sharded DLRM path runs on a ("data", "model") `DeviceMesh`
(`launch/mesh.make_host_mesh`).  A field is sharded over the model axis
iff its rows (`table_spec`'s, padded to 512) are at least
SHARD_ROWS_MIN and a multiple of 512, with interleaved placement: global
row r lives on model rank r % S at slot r // S (`interleave_shard` cuts
a rank's shard out of a whole table).  `dlrm_lookup_a2a` routes ids to
their owners and rows back (`routing.route` / `send_back`);
`dlrm_sparse_update_sharded` all-gathers (ids, bf16 gradients) over the
data axis and applies row-wise Adagrad to the rank's own rows;
`dlrm_train_step_sparse` differentiates the loss with respect to the
gathered (B, 26, D) rows only, so no dense table gradient is ever made.

SASRec and BERT4Rec share one encoder block (`models/attention.py`'s
`gqa_apply`, no rope, causal or bidirectional).  Their sampled-softmax
negatives are `prng.randint` on the raw key, bit for bit the reference's
`jax.random.randint`, and BERT4Rec's mask is `prng.uniform` of the first
half of `prng.split(key)`.  `topk_over_catalog` selects with
`layers.top_k`, which keeps `jax.lax.top_k`'s tie order (the lower index
first): the last chunk's clamped ids all score item n_items - 1 alike.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import routing
from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense, embed_lookup, embedding_bag,
                                       layer_norm, top_k)
from repro_torch.models.params import P, flatten, unflatten
from repro_torch.sharding import constrain

# Criteo-1TB per-field cardinalities (MLPerf DLRM reference, day_fea_count),
# capped at max_ind_range = 40M per the MLPerf benchmark convention.
CRITEO_TABLE_SIZES = [
    227_605_432, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    130_229_467, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    292_775_614, 40_790_948, 187_188_510, 590_152, 12_973, 108, 36,
]
MAX_IND_RANGE = 40_000_000


def criteo_tables(cap: int = MAX_IND_RANGE) -> list[int]:
    return [min(v, cap) for v in CRITEO_TABLE_SIZES]


# tables at/above this row count shard over the model axis; rows are padded
# to a 512 multiple so both production meshes divide evenly (pad rows are
# unreachable: lookups are bounded by the true cardinality)
SHARD_ROWS_MIN = 16_384


def round_rows(n: int, mult: int = 512) -> int:
    return n + (-n) % mult


def table_spec(rows: int, dim: int, init="normal:0.01") -> P:
    if rows >= SHARD_ROWS_MIN:
        return P((round_rows(rows), dim), ("table_rows", None), init)
    return P((rows, dim), (None, None), init)


def _mlp_stack_specs(dims: tuple, prefix_axes=(None, "mlp")) -> dict:
    specs = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs[f"w{i}"] = P((a, b), prefix_axes)
        specs[f"b{i}"] = P((b,), (None,), "zeros")  # biases replicate
    return specs


def _mlp_stack(params, x, n: int, final_act: bool = False):
    for i in range(n):
        x = dense(x, params[f"w{i}"], params[f"b{i}"])
        if i < n - 1 or final_act:
            x = F.relu(x)
    return x


# --------------------------------------------------------------------------
# DLRM (arXiv:1906.00091, MLPerf config)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    embed_dim: int = 128
    bot_mlp: tuple = (13, 512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    table_sizes: tuple = tuple(criteo_tables())
    # §Perf knobs of the reference (dlrm-mlperf/train_batch hillclimb)
    sparse_update: bool = False   # manual row-wise updates, no dense grads
    lookup: str = "gspmd"         # "gspmd" | "a2a" (routed lookup on a mesh)

    @property
    def n_sparse(self) -> int:
        return len(self.table_sizes)

    @property
    def interact_dim(self) -> int:
        n = self.n_sparse + 1
        return n * (n - 1) // 2 + self.embed_dim


def dlrm_specs(c: DLRMConfig) -> dict:
    return {
        "tables": {f"t{i}": table_spec(v, c.embed_dim)
                   for i, v in enumerate(c.table_sizes)},
        "bot": _mlp_stack_specs(c.bot_mlp),
        "top": _mlp_stack_specs((c.interact_dim,) + c.top_mlp),
    }


def dlrm_lookup(tables, sparse, c: DLRMConfig) -> torch.Tensor:
    """(B, n_sparse) ids -> (B, n_sparse, D) embeddings (one gather per
    field)."""
    sparse = sparse.long()
    return torch.stack([embed_lookup(tables[f"t{i}"], sparse[:, i])
                        for i in range(c.n_sparse)], dim=1)


def field_sharded(c: DLRMConfig) -> list[bool]:
    """Per field: is its table row-sharded over the model axis (its
    `table_spec` rows at least SHARD_ROWS_MIN and a multiple of 512)."""
    rows = [table_spec(v, c.embed_dim).shape[0] for v in c.table_sizes]
    return [r >= SHARD_ROWS_MIN and r % 512 == 0 for r in rows]


def interleave_shard(tree: dict, c: DLRMConfig, rank: int,
                     n_model: int) -> dict:
    """Model rank `rank`'s part of per-field leaves keyed "t{i}" (tables
    (rows, D), or accumulator dicts {"acc": (rows,)}): rows r % n_model ==
    rank, in order, of each sharded field; an unsharded field whole."""
    out = {}
    for i, sharded in enumerate(field_sharded(c)):
        leaf = tree[f"t{i}"]
        cut = (lambda t: t[rank::n_model].contiguous()) if sharded else (
            lambda t: t)
        out[f"t{i}"] = ({k: cut(v) for k, v in leaf.items()}
                        if isinstance(leaf, dict) else cut(leaf))
    return out


def _model_axis(mesh):
    """(group, size, this rank's index) of the mesh's "model" axis."""
    size = mesh.size(mesh.mesh_dim_names.index("model"))
    return mesh.get_group("model"), size, mesh.get_local_rank("model")


def dlrm_lookup_a2a(tables, sparse, c: DLRMConfig, mesh) -> torch.Tensor:
    """Routed lookup on `mesh` (every rank calls it): ids travel to the
    owner rank of the model axis, rows travel back.

    `tables`: this rank's tables, a sharded field's interleaved shard
    (`interleave_shard`: the Zipf head round-robins across ranks instead of
    flooding rank 0), an unsharded field whole; `sparse`: this rank's
    (B_loc, n_sparse) ids.  One capacity-bounded all-to-all pair per
    sharded field (capacity max(8, int(B_loc / S * 2.0)); ids past it
    come back as zero rows, as in the reference)."""
    group, n_model, _ = _model_axis(mesh)
    sparse = sparse.long()
    cap = max(8, int(sparse.shape[0] / n_model * 2.0))
    outs = []
    for i, sharded in enumerate(field_sharded(c)):
        ids_i = sparse[:, i]
        if not sharded:
            outs.append(F.embedding(ids_i, tables[f"t{i}"]))
            continue
        dest = ids_i % n_model                     # interleaved placement
        slot = torch.div(ids_i, n_model, rounding_mode="floor")
        recv, rt = routing.route({"idx": slot}, dest, cap, group)
        rows = F.embedding(recv["idx"], tables[f"t{i}"])
        rows = rows * rt.recv_valid[:, None].to(rows.dtype)
        outs.append(routing.send_back(rows, rt, group))
    return torch.stack(outs, dim=1)


def dlrm_apply_from_emb(params, dense_x, embs, c: DLRMConfig):
    """Interaction + MLPs given pre-looked-up embeddings (B, n_sparse, D)."""
    x = _mlp_stack(params["bot"], dense_x, len(c.bot_mlp) - 1,
                   final_act=True)                       # (B, 128)
    x = constrain(x, "batch", None)
    z = torch.cat([x[:, None, :], embs], dim=1)          # (B, 27, D)
    inter = torch.bmm(z, z.transpose(1, 2))              # pairwise dots
    # row-major strict upper triangle, the order of jnp.triu_indices
    iu, ju = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)
    feats = torch.cat([x, inter[:, iu, ju]], dim=-1)
    logit = _mlp_stack(params["top"], feats, len(c.top_mlp))
    return logit[:, 0]


def dlrm_apply(params, batch, c: DLRMConfig):
    """batch: dense (B, 13), sparse (B, 26) int -> logits (B,)."""
    embs = dlrm_lookup(params["tables"], batch["sparse"], c)
    return dlrm_apply_from_emb(params, batch["dense"], embs, c)


def dlrm_score_candidates(params, batch, cand_ids, c: DLRMConfig,
                          cand_field: int = 0):
    """Score ONE context row against C candidate values of `cand_field`.

    Everything except the candidate field's embedding is computed once
    and broadcast; interaction + top MLP run per candidate.  Candidate
    ids are taken modulo the field's cardinality, as the reference does.
    """
    x = _mlp_stack(params["bot"], batch["dense"], len(c.bot_mlp) - 1,
                   final_act=True)[0]                     # (128,)
    ctx = batch["sparse"][0].long()
    fixed = [embed_lookup(params["tables"][f"t{i}"], ctx[i])
             for i in range(c.n_sparse) if i != cand_field]
    cand = embed_lookup(params["tables"][f"t{cand_field}"],
                        cand_ids % c.table_sizes[cand_field])  # (C, D)
    cand = constrain(cand, "candidates", None)
    zf = torch.stack([x] + fixed, dim=0)                 # (26, D)
    inter_ff = zf @ zf.T                                 # fixed x fixed
    inter_fc = cand @ zf.T                               # (C, 26)
    iu, ju = torch.triu_indices(zf.shape[0], zf.shape[0], 1,
                                device=zf.device)
    base = torch.cat([x, inter_ff[iu, ju]])              # shared features
    feats = torch.cat([base.expand(cand.shape[0], base.shape[0]), inter_fc],
                      dim=-1)                            # (C, interact_dim)
    logit = _mlp_stack(params["top"], feats, len(c.top_mlp))
    return logit[:, 0]


def _bce(logit, y):
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def dlrm_loss(params, batch, c: DLRMConfig):
    loss = _bce(dlrm_apply(params, batch, c), batch["label"])
    return loss, {"bce": loss}


@torch.no_grad()
def _rowwise_adagrad(t, acc, slot, mine, g, opt_cfg) -> None:
    """Row-wise Adagrad in place on the rows `slot` of table t and its
    accumulator acc, for the entries where `mine` (None: all), in the
    reference's expression order: acc[slot] += mean(g^2), then
    t[slot] -= lr / sqrt(max(acc[slot] + eps, 1e-30)) * g.  The entries
    not mine add -0.0 to row 0, which changes no value (the reference
    drops them)."""
    ms = torch.mean(torch.square(g), dim=-1)
    if mine is not None:
        slot = torch.where(mine, slot, torch.zeros_like(slot))
        ms = torch.where(mine, ms, torch.full_like(ms, -0.0))
    acc.index_add_(0, slot, ms)
    scale = opt_cfg.table_lr / torch.sqrt(
        torch.clamp(acc[slot] + opt_cfg.table_eps, min=1e-30))
    upd = -(scale[:, None] * g).to(t.dtype)
    if mine is not None:
        upd = torch.where(mine[:, None], upd, torch.full_like(upd, -0.0))
    t.index_add_(0, slot, upd)


def dlrm_sparse_update_sharded(tables, accs, sparse_ids, g_emb,
                               c: DLRMConfig, opt_cfg, mesh):
    """Row-wise Adagrad applied rank-locally (interleaved row placement),
    IN PLACE on this rank's tables and accumulators (every rank calls it).

    All-gather the (ids, grad) updates over the mesh's data axis once (the
    irreducible data-parallel volume; the gradients travel as bf16, as in
    the reference), then each model rank applies exactly its own rows of
    each sharded field, and every rank all of each unsharded field's:
    no further collectives.  `accs`: {"t{i}": {"acc": (rows_loc,)}}.
    Returns (tables, accs)."""
    data = mesh.get_group("data")
    _, n_model, col = _model_axis(mesh)
    # tiled: every data rank's rows in rank order, as the reference's
    # all_gather(..., tiled=True); gradients as bf16 on the wire (as
    # bytes: gloo moves no 16-bit integers)
    ids_g = routing.all_gather(sparse_ids.long(), data).flatten(0, 1)
    g_g = routing.all_gather(g_emb.to(torch.bfloat16).view(torch.uint8),
                             data).flatten(0, 1).view(torch.bfloat16).float()
    for i, sharded in enumerate(field_sharded(c)):
        key = f"t{i}"
        ids_i = ids_g[:, i]
        if sharded:
            mine = (ids_i % n_model) == col
            slot = torch.div(ids_i, n_model, rounding_mode="floor")
        else:
            mine, slot = None, ids_i
        _rowwise_adagrad(tables[key], accs[key]["acc"], slot, mine,
                         g_g[:, i], opt_cfg)
    return tables, accs


def dlrm_train_step_sparse(params, opt_state, batch, opt_step, seed,
                           c: DLRMConfig, opt_cfg, dense_update, mesh=None):
    """Sparse-table train step: embedding gradients never densify.

    The autograd of a lookup makes a (rows, D) gradient per table.  Here
    tables are looked up without gradient; the loss is differentiated
    with respect to the GATHERED rows (B, 26, D) and the dense leaves, and
    row-wise Adagrad updates exactly the touched rows (the production TBE
    pattern).  Memory traffic scales with B * 26 * D instead of
    sum(rows) * D.  `dense_update`: `make_optimizer`'s update of the
    bot / top leaves (in place).  With `c.lookup == "a2a"` and a `mesh`,
    the lookup and the update are the routed, row-sharded ones.  `seed`
    is unused, as in the reference.  Tables and accumulators are updated
    in place; returns (params, opt_state, {"loss", **dense stats})."""
    tables = params["tables"]
    routed = c.lookup == "a2a" and mesh is not None
    with torch.no_grad():
        embs = (dlrm_lookup_a2a(tables, batch["sparse"], c, mesh) if routed
                else dlrm_lookup(tables, batch["sparse"], c))
    dense_p = {"bot": params["bot"], "top": params["top"]}
    leaves = {k: v.detach().requires_grad_()
              for k, v in flatten(dense_p).items()}
    embs.requires_grad_()
    with torch.enable_grad():
        loss = _bce(dlrm_apply_from_emb(unflatten(leaves), batch["dense"],
                                        embs, c), batch["label"])
        *g_dense, g_emb = torch.autograd.grad(
            loss, list(leaves.values()) + [embs])
    g_dense = unflatten(dict(zip(leaves, g_dense)))
    new_dense, new_dense_state, stats = dense_update(
        g_dense, opt_state["dense"], dense_p, opt_step)
    if routed:
        dlrm_sparse_update_sharded(tables, opt_state["tables"],
                                   batch["sparse"], g_emb, c, opt_cfg, mesh)
    else:
        ids = batch["sparse"].long()
        for i in range(c.n_sparse):
            key = f"t{i}"
            _rowwise_adagrad(tables[key], opt_state["tables"][key]["acc"],
                             ids[:, i], None, g_emb[:, i].float(), opt_cfg)
    return ({"tables": tables, **new_dense},
            {"dense": new_dense_state, "tables": opt_state["tables"]},
            {"loss": loss.detach(), **stats})


# --------------------------------------------------------------------------
# shared transformer encoder block (SASRec / BERT4Rec)
# --------------------------------------------------------------------------

def _enc_block_specs(d: int, n_heads: int, d_ff: int) -> dict:
    return {
        "attn": attn.gqa_specs(attn.GQAConfig(d_model=d, n_heads=n_heads,
                                              n_kv_heads=n_heads,
                                              d_head=d // n_heads)),
        "ln1_s": P((d,), (None,), "ones"), "ln1_b": P((d,), (None,), "zeros"),
        "ln2_s": P((d,), (None,), "ones"), "ln2_b": P((d,), (None,), "zeros"),
        "ff1": P((d, d_ff), (None, "mlp")),
        "ff1b": P((d_ff,), ("mlp",), "zeros"),
        "ff2": P((d_ff, d), ("mlp", None)), "ff2b": P((d,), (None,), "zeros"),
    }


def _enc_block(p, x, d: int, n_heads: int, causal: bool):
    cfg = attn.GQAConfig(d_model=d, n_heads=n_heads, n_kv_heads=n_heads,
                         d_head=d // n_heads)
    h = layer_norm(x, p["ln1_s"], p["ln1_b"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    a, _ = attn.gqa_apply(p["attn"], h, positions, cfg,
                          kind="global" if causal else "bidir",
                          use_rope=False)
    x = x + a
    h = layer_norm(x, p["ln2_s"], p["ln2_b"])
    f = dense(F.relu(dense(h, p["ff1"], p["ff1b"])), p["ff2"], p["ff2b"])
    return x + f


# --------------------------------------------------------------------------
# SASRec (arXiv:1808.09781)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_neg: int = 128          # sampled-softmax negatives (adaptation for 1M items)
    causal: bool = True
    mask_frac: float = 0.0    # BERT4Rec sets > 0

    @property
    def pad_id(self) -> int:
        return self.n_items       # one extra row: PAD (SASRec) / MASK (BERT4Rec)


def sasrec_specs(c: SASRecConfig) -> dict:
    return {
        "items": table_spec(c.n_items + 1, c.embed_dim),
        "pos": P((c.seq_len, c.embed_dim), (None, None), "normal:0.01"),
        "blocks": {f"b{i}": _enc_block_specs(c.embed_dim, c.n_heads,
                                             c.embed_dim)
                   for i in range(c.n_blocks)},
        "ln_s": P((c.embed_dim,), (None,), "ones"),
        "ln_b": P((c.embed_dim,), (None,), "zeros"),
    }


def sasrec_encode(params, history, c: SASRecConfig):
    """history (B, S) item ids -> (B, S, D) contextual item states."""
    x = embed_lookup(params["items"], history)
    x = x + params["pos"][None, :, :].to(x.dtype)
    x = constrain(x, "batch", None, None)
    for i in range(c.n_blocks):
        x = _enc_block(params["blocks"][f"b{i}"], x, c.embed_dim, c.n_heads,
                       causal=c.causal)
    return layer_norm(x, params["ln_s"], params["ln_b"])


def _sampled_softmax(params, h, target, rng, c: SASRecConfig,
                     logq: torch.Tensor | None = None):
    """h (B, D) vs target (B,) + n_neg uniform negatives -> CE loss.
    `rng`: a raw threefry key ((2,) uint32)."""
    negs = prng.randint(rng, (c.n_neg,), 0, c.n_items, device=h.device)
    cand = torch.cat([target.long(), negs.long()])       # (B + n_neg,)
    e = embed_lookup(params["items"], cand)              # (B+n, D)
    logits = (h @ e.T).float()                           # (B, B+n)
    if logq is not None:
        logits = logits - logq[None, :]
    logp = F.log_softmax(logits, dim=-1)
    return -logp.diagonal().mean()


def sasrec_loss(params, batch, c: SASRecConfig, rng):
    h = sasrec_encode(params, batch["history"], c)[:, -1]  # next-item state
    loss = _sampled_softmax(params, h, batch["target"], rng, c)
    return loss, {"ce": loss}


def bert4rec_loss(params, batch, c: SASRecConfig, rng):
    """Masked-item modeling: mask ~mask_frac of positions, predict originals."""
    hist = batch["history"]
    b, s = hist.shape
    r_mask, r_neg = prng.split(rng, 2)
    m = prng.uniform(r_mask, (b, s), device=hist.device) < c.mask_frac
    m[:, -1] = True  # always learn the last position
    masked = torch.where(m, torch.full_like(hist, c.pad_id), hist)
    hseq = sasrec_encode(params, masked, c)              # bidirectional
    # loss on the final masked position (fixed-shape; other masks act as noise)
    loss = _sampled_softmax(params, hseq[:, -1], hist[:, -1], r_neg, c)
    return loss, {"ce": loss}


def score_candidates(params, h, cand_ids):
    """h (B, D) x candidate ids (C,) -> (B, C) scores (retrieval_cand cell)."""
    e = embed_lookup(params["items"], cand_ids)
    e = constrain(e, "candidates", None)
    return (h @ e.T).float()


def topk_over_catalog(params, h, c: SASRecConfig, k: int = 100,
                      chunk: int = 65_536):
    """Top-k items for each user state without materializing (B, n_items).

    A loop over candidate chunks keeps peak memory at B*chunk scores;
    chunk winners are re-ranked at the end (exact top-k).  Ids past the
    catalog in the last chunk are clamped to n_items - 1, as in the
    reference, and ties keep the lower position first."""
    n_chunks = -(-c.n_items // chunk)
    base = torch.arange(chunk, dtype=torch.int64, device=h.device)
    vals, idx = [], []
    for i in range(n_chunks):
        ids = torch.clamp(i * chunk + base, max=c.n_items - 1)
        v, j = top_k(score_candidates(params, h, ids), k)  # (B, k)
        vals.append(v)
        idx.append(ids[j])
    vals = torch.stack(vals, dim=1).reshape(h.shape[0], -1)
    idx = torch.stack(idx, dim=1).reshape(h.shape[0], -1)
    v, j = top_k(vals, k)
    return v, torch.gather(idx, 1, j)


# --------------------------------------------------------------------------
# Two-tower retrieval (Yi et al., RecSys'19) with sketch logQ correction
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    n_users: int = 5_000_000
    n_items: int = 1_000_000
    embed_dim: int = 256
    tower: tuple = (1024, 512, 256)
    n_user_feats: int = 8
    n_item_feats: int = 8
    temperature: float = 0.05


def twotower_specs(c: TwoTowerConfig) -> dict:
    dims = (c.embed_dim,) + c.tower
    return {
        "user_table": table_spec(c.n_users, c.embed_dim),
        "item_table": table_spec(c.n_items, c.embed_dim),
        "user_tower": _mlp_stack_specs(dims),
        "item_tower": _mlp_stack_specs(dims),
    }


def _tower(params, table, feats, tower_dims):
    x = embedding_bag(table, feats, mode="mean")
    x = _mlp_stack(params, x, len(tower_dims))
    norm = x.square().sum(dim=-1, keepdim=True).sqrt()
    return x / torch.clamp(norm, min=1e-6)


def twotower_embed(params, batch, c: TwoTowerConfig):
    u = _tower(params["user_tower"], params["user_table"],
               batch["user_feats"], c.tower)
    v = _tower(params["item_tower"], params["item_table"],
               batch["item_feats"], c.tower)
    return u, v


def twotower_loss(params, batch, c: TwoTowerConfig):
    """In-batch softmax with logQ correction.

    batch["item_logq"]: log sampling probability of each in-batch item,
    estimated from the CMLS sketch (count / total) by the data pipeline.
    """
    u, v = twotower_embed(params, batch, c)
    logits = (u @ v.T).float() / c.temperature
    logq = batch.get("item_logq")
    if logq is not None:
        logits = logits - logq[None, :]
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.diagonal().mean()
    return loss, {"ce": loss}


def twotower_score_candidates(params, batch, cand_feats, c: TwoTowerConfig):
    """One query against C candidate items (C = 10^6 in retrieval_cand)."""
    u = _tower(params["user_tower"], params["user_table"],
               batch["user_feats"], c.tower)
    v = _tower(params["item_tower"], params["item_table"], cand_feats,
               c.tower)
    v = constrain(v, "candidates", None)
    return (u @ v.T).float() / c.temperature
