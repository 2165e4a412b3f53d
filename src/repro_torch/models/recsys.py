"""RecSys model family, PyTorch: DLRM and two-tower retrieval.

Counterpart of the DLRM and two-tower halves of `repro/models/recsys.py`.
The counting plane (the paper's CMLS sketch) enters here in two places:
  * admission -- ids pass through a sketch-gated admission map before
    the embedding lookup (`core/admission.py`; the tables are then
    `n_fallback + table_rows` rows, see `examples/recsys_admission_torch`);
  * two-tower in-batch softmax applies logQ correction with sampling
    probabilities estimated from the sketch (the `item_logq` input).

Lookups are `F.embedding` / `F.embedding_bag` (the reference's `jnp.take`
and gather + reduce), the matrix products `torch.matmul` / `bmm`, and
autograd computes every gradient: no Pallas kernel sits on this path.
The reference's `constrain` calls do nothing outside its `use_rules`
context and are left out until the sharding slice, which also brings
`dlrm_lookup_a2a`, `dlrm_sparse_update_sharded` and
`dlrm_train_step_sparse`; SASRec and BERT4Rec come with the attention
layers of the LM slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, embedding_bag
from repro_torch.models.params import P

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
    # §Perf knobs of the reference (dlrm-mlperf/train_batch hillclimb); the
    # sharded paths they select come with the sharding slice
    sparse_update: bool = False   # manual row-wise updates, no dense grads
    lookup: str = "gspmd"         # "gspmd" | "a2a" (routed shard_map lookup)

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
    return torch.stack([F.embedding(sparse[:, i], tables[f"t{i}"])
                        for i in range(c.n_sparse)], dim=1)


def dlrm_apply_from_emb(params, dense_x, embs, c: DLRMConfig):
    """Interaction + MLPs given pre-looked-up embeddings (B, n_sparse, D)."""
    x = _mlp_stack(params["bot"], dense_x, len(c.bot_mlp) - 1,
                   final_act=True)                       # (B, 128)
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
    fixed = [params["tables"][f"t{i}"][ctx[i]]
             for i in range(c.n_sparse) if i != cand_field]
    cand = F.embedding((cand_ids % c.table_sizes[cand_field]).long(),
                       params["tables"][f"t{cand_field}"])  # (C, D)
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
    return (u @ v.T).float() / c.temperature
