"""GNN batch builders, a numpy copy of ``repro/data/graphs.py`` for the
port: full-graph batches, batched molecular graphs with triplet lists
(DimeNet), and synthetic labels/features — all deterministic, equal bit
for bit to the reference's for the same seed.  Host code: the caller
moves the arrays to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs import Graph, src_of_edges


@dataclasses.dataclass(frozen=True)
class FullGraphBatch:
    node_feat: np.ndarray     # (N+1, F) zero dummy row
    senders: np.ndarray       # (E,) int32 dummy = N
    receivers: np.ndarray
    labels: np.ndarray        # (N+1,) int32
    train_mask: np.ndarray    # (N+1,) bool


def full_graph_batch(g: Graph, d_feat: int, n_classes: int, *,
                     seed: int = 0, train_frac: float = 0.3
                     ) -> FullGraphBatch:
    rng = np.random.default_rng(seed)
    n = g.n
    feat = np.zeros((n + 1, d_feat), dtype=np.float32)
    labels = np.zeros(n + 1, dtype=np.int32)
    # community-correlated features/labels so training is learnable
    labels[:n] = rng.integers(0, n_classes, n)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feat[:n] = centers[labels[:n]] + 0.5 * rng.normal(
        size=(n, d_feat)).astype(np.float32)
    senders = src_of_edges(g).astype(np.int32)
    receivers = g.indices.astype(np.int32)
    mask = np.zeros(n + 1, dtype=bool)
    mask[:n] = rng.random(n) < train_frac
    return FullGraphBatch(node_feat=feat, senders=senders,
                          receivers=receivers, labels=labels,
                          train_mask=mask)


@dataclasses.dataclass(frozen=True)
class MoleculeBatch:
    """B molecules flattened into one disjoint graph with fixed shapes."""
    species: np.ndarray     # (B*max_n + 1,) int32, dummy last
    pos: np.ndarray         # (B*max_n + 1, 3)
    senders: np.ndarray     # (B*max_e,) dummy = B*max_n
    receivers: np.ndarray
    t_kj: np.ndarray        # (T_cap,) triplet edge ids, dummy = B*max_e
    t_ji: np.ndarray
    graph_ids: np.ndarray   # (B*max_n + 1,) int32, dummy = B
    targets: np.ndarray     # (B,) float32 synthetic energies


def molecule_batch(batch: int, max_nodes: int, max_edges: int, *,
                   n_species: int = 8, cutoff: float = 2.5,
                   triplet_cap_per_graph: int | None = None,
                   seed: int = 0) -> MoleculeBatch:
    rng = np.random.default_rng(seed)
    NB = batch * max_nodes
    EB = batch * max_edges
    t_cap = batch * (triplet_cap_per_graph or 4 * max_edges)
    species = np.zeros(NB + 1, dtype=np.int32)
    pos = np.zeros((NB + 1, 3), dtype=np.float32)
    senders = np.full(EB, NB, dtype=np.int32)
    receivers = np.full(EB, NB, dtype=np.int32)
    graph_ids = np.full(NB + 1, batch, dtype=np.int32)
    t_kj = np.full(t_cap, EB, dtype=np.int32)
    t_ji = np.full(t_cap, EB, dtype=np.int32)
    targets = np.zeros(batch, dtype=np.float32)
    e_ptr = 0
    t_ptr = 0
    for b in range(batch):
        n = rng.integers(max(4, max_nodes // 2), max_nodes + 1)
        base = b * max_nodes
        species[base:base + n] = rng.integers(1, n_species, n)
        p = rng.normal(size=(n, 3)).astype(np.float32) * 1.2
        pos[base:base + n] = p
        graph_ids[base:base + n] = b
        # radius edges (directed both ways)
        d2 = ((p[:, None] - p[None, :]) ** 2).sum(-1)
        ii, jj = np.nonzero((d2 < cutoff ** 2) & (d2 > 1e-9))
        order = rng.permutation(len(ii))[:max_edges]
        ii, jj = ii[order], jj[order]
        e_base = e_ptr
        eids = {}
        for k in range(len(ii)):
            senders[e_ptr] = base + ii[k]
            receivers[e_ptr] = base + jj[k]
            eids[(ii[k], jj[k])] = e_ptr
            e_ptr += 1
        # triplets (k->j, j->i), k != i
        in_edges: dict[int, list] = {}
        for (s, d), eid in eids.items():
            in_edges.setdefault(d, []).append((s, eid))
        for (j, i), e_ji in eids.items():
            for (k, e_kj) in in_edges.get(j, []):
                if k == i:
                    continue
                if t_ptr < t_cap:
                    t_kj[t_ptr] = e_kj
                    t_ji[t_ptr] = e_ji
                    t_ptr += 1
        targets[b] = species[base:base + n].sum() * 0.1 \
            + 0.01 * float(d2[d2 < cutoff ** 2].sum())
        e_ptr = e_base + max_edges  # fixed stride per graph
    return MoleculeBatch(species=species, pos=pos, senders=senders,
                         receivers=receivers, t_kj=t_kj, t_ji=t_ji,
                         graph_ids=graph_ids, targets=targets)


def recsys_batch(batch: int, n_fields: int, rows_per_field: int, *,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Criteo-like synthetic CTR batch with learnable structure: the label
    correlates with a hidden score of a few 'strong' feature ids."""
    rng = np.random.default_rng(seed)
    # power-law id popularity
    u = rng.random((batch, n_fields))
    ids = np.minimum((rows_per_field * u ** 3).astype(np.int64),
                     rows_per_field - 1).astype(np.int32)
    strength = np.sin(ids[:, :8].sum(axis=1) * 0.37)
    labels = (strength + 0.3 * rng.normal(size=batch) > 0).astype(np.float32)
    return ids, labels
