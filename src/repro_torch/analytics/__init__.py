"""Graph analytics riding the BVSS multi-source wave engine (DESIGN §2.6),
the PyTorch port of ``repro/analytics``.

Every algorithm here is a *client* of the wave machinery
(``core.multi_source``), never a bespoke traversal:

* :mod:`~repro_torch.analytics.components` — connected components as
  batched flood-fill with iterative re-seeding through ``drive_wave``;
* :mod:`~repro_torch.analytics.eccentricity` — eccentricity, diameter and
  radius via iFUB sweeps batched through the fixed-cohort engine;
* :mod:`~repro_torch.analytics.closeness` — exact and sampled closeness
  centrality as a reduction over wave level channels;
* :mod:`~repro_torch.analytics.betweenness` — Brandes betweenness: the σ
  path-count channel forward (``bvss_spmm_w``), the transposed tile
  product backward (``bvss_spmm_t``);
* :mod:`~repro_torch.analytics.sssp` — delta-stepping SSSP through the
  min-plus tile product against the edge-weight plane
  (``bvss_spmm_minplus``);
* :mod:`~repro_torch.analytics.pagerank` — PageRank as a float-channel
  power iteration over the weighted tile product (``bvss_spmm_w``).

All functions speak the id space of the problem/graph
they are handed; ``repro_torch.serve.GraphSession`` layers the caller-id
contract and the symmetrised problem on top.
"""
from repro_torch.analytics.betweenness import (betweenness_centrality,
                                               make_betweenness)
from repro_torch.analytics.closeness import (closeness_centrality,
                                             closeness_from_levels)
from repro_torch.analytics.components import connected_components
from repro_torch.analytics.eccentricity import (ExtremesReport,
                                                eccentricities,
                                                ifub_extremes)
from repro_torch.analytics.pagerank import (make_pagerank, out_degrees,
                                            pagerank_scores)
from repro_torch.analytics.sssp import (default_delta, make_sssp,
                                        sssp_distances)

__all__ = ["betweenness_centrality", "make_betweenness",
           "closeness_centrality", "closeness_from_levels",
           "connected_components", "eccentricities", "ifub_extremes",
           "ExtremesReport", "make_sssp", "sssp_distances", "default_delta",
           "make_pagerank", "pagerank_scores", "out_degrees"]
