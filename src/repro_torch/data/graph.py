"""Graph substrate: CSR storage, neighbor sampling, DimeNet triplet lists.

Counterpart of `repro/data/graph.py`: numpy on the host, the reference's
code statement for statement, so the same seed and `np.random.Generator`
give bit-identical arrays (the reference module imports no JAX, but the
port keeps its own copy rather than import the reference package).

Everything returns *fixed shapes* (pad + mask): the sampler emits exactly
batch * prod(fanouts) tree edges, and the triplet builder exactly
n_edges * max_angular triplets.  The reference's docstring speaks of a
CMLS sketch for the sampler's degree statistics; its code keeps the dense
CSR degree (`indptr` differences), and so does the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray    # (n_nodes + 1,) int64
    indices: np.ndarray   # (n_edges,) int32, incoming-neighbor lists
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.size)


def synthetic_graph(n_nodes: int, n_edges: int, seed: int = 0,
                    power: float = 1.5) -> CSRGraph:
    """Power-law multigraph via degree-weighted endpoint sampling."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_nodes + 1) ** power
    w /= w.sum()
    dst = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
    src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRGraph(indptr=indptr, indices=src, n_nodes=n_nodes)


def sample_neighbors(graph: CSRGraph, seeds: np.ndarray, fanouts: list[int],
                     rng: np.random.Generator):
    """GraphSAGE-style layered sampler with fixed output shapes.

    Tree-structured (no dedup): layer l has len(seeds) * prod(fanouts[:l])
    nodes.  Returns (node_ids, edge_src, edge_dst, edge_mask) where edges
    point child -> parent position (message flows to the parent), and
    edge_mask zeroes edges sampled from isolated nodes.
    """
    nodes = [seeds.astype(np.int32)]
    srcs, dsts, masks = [], [], []
    offset = 0
    frontier = seeds.astype(np.int64)
    for f in fanouts:
        deg = graph.indptr[frontier + 1] - graph.indptr[frontier]
        has = deg > 0
        # sample-with-replacement positions within each neighbor list
        r = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(frontier), f))
        child_ids = graph.indices[
            (graph.indptr[frontier][:, None] + r).clip(0, graph.n_edges - 1)]
        child_ids = np.where(has[:, None], child_ids, frontier[:, None])
        parent_pos = offset + np.arange(len(frontier))
        child_pos = offset + len(frontier) + np.arange(len(frontier) * f)
        srcs.append(child_pos.astype(np.int32))
        dsts.append(np.repeat(parent_pos, f).astype(np.int32))
        masks.append(np.repeat(has, f))
        nodes.append(child_ids.reshape(-1).astype(np.int32))
        offset += len(frontier)
        frontier = child_ids.reshape(-1).astype(np.int64)
    return (np.concatenate(nodes),
            np.concatenate(srcs), np.concatenate(dsts),
            np.concatenate(masks))


def subgraph_sizes(batch_nodes: int, fanouts: list[int]):
    """(n_sub_nodes, n_sub_edges) of the fixed-shape sampled subgraph."""
    n_nodes, n_edges, frontier = batch_nodes, 0, batch_nodes
    for f in fanouts:
        n_edges += frontier * f
        frontier *= f
        n_nodes += frontier
    return n_nodes, n_edges


def build_triplets(edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int,
                   max_angular: int, rng: np.random.Generator):
    """DimeNet triplet lists: pairs (k->j, j->i) of incident edges.

    For every edge e = (j -> i), sample up to `max_angular` incoming edges
    (k -> j), k != i.  Fixed shape: (n_edges * max_angular,) indices into
    the edge list + validity mask.  Sampling (rather than enumerating
    sum(deg^2) triplets) is the documented large-graph adaptation.
    """
    n_edges = len(edge_src)
    # incoming-edge CSR keyed by dst
    order = np.argsort(edge_dst, kind="stable")
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, edge_dst.astype(np.int64) + 1, 1)
    np.cumsum(indptr, out=indptr)
    j = edge_src.astype(np.int64)                       # tail node of e
    deg_j = indptr[j + 1] - indptr[j]
    r = rng.integers(0, np.maximum(deg_j, 1)[:, None],
                     size=(n_edges, max_angular))
    kj = order[(indptr[j][:, None] + r).clip(0, n_edges - 1)]
    ji = np.broadcast_to(np.arange(n_edges)[:, None], (n_edges, max_angular))
    valid = (deg_j[:, None] > 0) & (edge_src[kj] != edge_dst[ji])  # k != i
    return (kj.reshape(-1).astype(np.int32),
            ji.reshape(-1).astype(np.int32).copy(),
            valid.reshape(-1))


def batched_molecules(batch: int, n_nodes: int, n_edges: int, seed: int = 0):
    """Batch of small 3D graphs, flattened with graph offsets (shape-static)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(batch * n_nodes, 3)).astype(np.float32)
    z = rng.integers(1, 10, size=(batch * n_nodes,)).astype(np.int32)
    src = rng.integers(0, n_nodes, size=(batch, n_edges))
    dst = (src + 1 + rng.integers(0, n_nodes - 1, size=(batch, n_edges))) % n_nodes
    off = (np.arange(batch) * n_nodes)[:, None]
    graph_id = np.repeat(np.arange(batch), n_nodes).astype(np.int32)
    return {"pos": pos, "atom_z": z,
            "edge_src": (src + off).reshape(-1).astype(np.int32),
            "edge_dst": (dst + off).reshape(-1).astype(np.int32),
            "graph_id": graph_id, "n_graphs": batch}
