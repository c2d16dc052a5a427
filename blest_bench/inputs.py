"""A cell's inputs, made from its configuration and the run's seed.

The configuration file names a generator family (``graphs/<family>.py``),
its parameters and the seed of the graph (``graph_seed``), which draws the
structure and a random relabelling of the vertices, so the port's ordering
gets unordered input.  The graph is one fixed instance, as a published one
is.  The run's ``--seed`` draws the roots: every seed serves the same graph
with other roots.  (Relabelling from ``--seed`` moved the port's RCM
ordering, and with it the rgg cell's time a level, by 3.5% between seeds.)

Both sides get the same edge list: the simple undirected graph, self-loops
and repeats removed, each edge once as ``(a[i], b[i])`` with ``a < b``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np


def load_module(path: Path, name: str):
    """Import the Python file at ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def module_name(kind: str, name: str) -> str:
    """A module name for a file found by a name that may hold dots or dashes."""
    return "blest_bench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass(frozen=True)
class Edges:
    """A simple undirected graph: ``n`` vertices, edge ``i`` joins ``a[i] < b[i]``."""

    n: int
    a: np.ndarray
    b: np.ndarray

    @property
    def m(self) -> int:
        return len(self.a)

    def directed(self) -> tuple[np.ndarray, np.ndarray]:
        """Both directions of every edge, as the port's ``from_edges`` takes them."""
        return np.concatenate([self.a, self.b]), np.concatenate([self.b, self.a])

    def degree(self) -> np.ndarray:
        return np.bincount(self.a, minlength=self.n) + \
            np.bincount(self.b, minlength=self.n)


def simple_undirected(n: int, u: np.ndarray, v: np.ndarray) -> Edges:
    """Drop self-loops and repeats; each undirected edge once, ``a < b``."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    keep = u != v
    lo, hi = np.minimum(u[keep], v[keep]), np.maximum(u[keep], v[keep])
    key = np.unique(lo * n + hi)
    return Edges(n, key // n, key % n)


def make_graph(config: dict, bench_dir: Path) -> Edges:
    """The configuration's graph, its vertices relabelled at random."""
    gen = config["generator"]
    family = load_module(bench_dir / "graphs" / f"{gen['family']}.py",
                         module_name("graph", gen["family"]))
    graph_seed = int(gen["graph_seed"])
    n, u, v = family.edge_tuples(gen["params"],
                                 np.random.default_rng(graph_seed))
    labels = np.random.default_rng([graph_seed, 0]).permutation(n)
    return simple_undirected(n, labels[u], labels[v])


class Roots:
    """Batches of roots drawn from the seed: uniform over the vertices of
    degree at least one (Graph 500's rule for search keys), distinct within
    a batch.  ``stream`` 0 feeds the measured window, 1 the warm-up."""

    def __init__(self, edges: Edges, seed: int, stream: int = 0):
        self.candidates = np.flatnonzero(edges.degree() > 0)
        self.rng = np.random.default_rng([int(seed), 1, stream])

    def batch(self, k: int) -> np.ndarray:
        k = min(int(k), len(self.candidates))
        return self.rng.choice(self.candidates, size=k, replace=False)
