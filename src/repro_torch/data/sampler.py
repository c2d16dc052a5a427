"""Fanout-bounded neighbor sampler for minibatch GNN training, a numpy
copy of ``repro/data/sampler.py`` for the port: for the same graph, seeds
and seed it gives the reference's batch bit for bit.  It stays host code,
as in the reference (DESIGN §4).

GraphSAGE-style sampling IS fanout-limited BFS frontier expansion: level k
of the BFS from the seed nodes is the k-hop neighbourhood, and the fanout
cap subsamples each frontier pull.  This sampler reuses the framework's
in-CSR view and (like the BLEST queue) tracks the frontier explicitly.

Output is a fixed-shape padded subgraph (dummy node = n_sub) ready for the
segment-sum GNN models.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs import Graph


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """Fixed-shape sampled subgraph: local ids, dummy node = n_nodes-1 slot
    ``n_sub`` (arrays are sized for it)."""
    node_ids: np.ndarray      # (max_nodes,) global ids, -1 padded
    senders: np.ndarray       # (max_edges,) local ids, dummy = max_nodes
    receivers: np.ndarray     # (max_edges,)
    seed_mask: np.ndarray     # (max_nodes,) bool: the labelled seed nodes
    n_real_nodes: int
    n_real_edges: int


class NeighborSampler:
    def __init__(self, g: Graph, fanouts: tuple[int, ...], *, seed: int = 0):
        self.g = g
        self.fanouts = fanouts
        # sampling pulls from in-neighbours (messages flow src -> dst)
        self.t_indptr, self.t_indices = g.t_csr
        self.rng = np.random.default_rng(seed)

    def _sample_in_neighbors(self, nodes: np.ndarray, fanout: int
                             ) -> tuple[np.ndarray, np.ndarray]:
        """Per node, up to ``fanout`` sampled in-neighbours.
        Returns (srcs, dsts) edge endpoints."""
        srcs, dsts = [], []
        for u in nodes:
            lo, hi = self.t_indptr[u], self.t_indptr[u + 1]
            deg = hi - lo
            if deg == 0:
                continue
            if deg <= fanout:
                nbr = self.t_indices[lo:hi]
            else:
                sel = self.rng.choice(deg, size=fanout, replace=False)
                nbr = self.t_indices[lo + sel]
            srcs.append(nbr.astype(np.int64))
            dsts.append(np.full(len(nbr), u, dtype=np.int64))
        if not srcs:
            return (np.zeros(0, np.int64),) * 2
        return np.concatenate(srcs), np.concatenate(dsts)

    def sample(self, seeds: np.ndarray, *, max_nodes: int, max_edges: int
               ) -> SampledBatch:
        """BFS frontier expansion with per-level fanout caps."""
        seeds = np.asarray(seeds, dtype=np.int64)
        visited = dict((int(u), i) for i, u in enumerate(seeds))
        frontier = seeds
        all_src, all_dst = [], []
        for fanout in self.fanouts:          # one BFS level per fanout entry
            src, dst = self._sample_in_neighbors(frontier, fanout)
            all_src.append(src)
            all_dst.append(dst)
            new = []
            for u in src:                    # next frontier = newly seen
                if int(u) not in visited:
                    visited[int(u)] = len(visited)
                    new.append(u)
            frontier = np.asarray(new, dtype=np.int64)
            if len(frontier) == 0:
                break
        src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
        # localise + pad
        node_ids = np.full(max_nodes, -1, dtype=np.int64)
        n_real = min(len(visited), max_nodes)
        inv = {}
        for gid, lid in visited.items():
            if lid < max_nodes:
                node_ids[lid] = gid
                inv[gid] = lid
        keep = np.array([int(s) in inv and int(d) in inv
                         for s, d in zip(src, dst)], dtype=bool) \
            if len(src) else np.zeros(0, bool)
        src_l = np.array([inv[int(s)] for s in src[keep]], dtype=np.int32) \
            if keep.any() else np.zeros(0, np.int32)
        dst_l = np.array([inv[int(d)] for d in dst[keep]], dtype=np.int32) \
            if keep.any() else np.zeros(0, np.int32)
        n_edges = min(len(src_l), max_edges)
        senders = np.full(max_edges, max_nodes, dtype=np.int32)
        receivers = np.full(max_edges, max_nodes, dtype=np.int32)
        senders[:n_edges] = src_l[:n_edges]
        receivers[:n_edges] = dst_l[:n_edges]
        seed_mask = np.zeros(max_nodes, dtype=bool)
        seed_mask[:min(len(seeds), max_nodes)] = True
        return SampledBatch(node_ids=node_ids, senders=senders,
                            receivers=receivers, seed_mask=seed_mask,
                            n_real_nodes=n_real, n_real_edges=n_edges)
