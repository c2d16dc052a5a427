"""Graph analytics riding the BVSS multi-source wave engine (DESIGN §2.6),
the PyTorch port of ``repro/analytics``.

Every algorithm here is a *client* of the wave machinery
(``core.multi_source``), never a bespoke traversal:

* :mod:`~repro_torch.analytics.components` — connected components as
  batched flood-fill with iterative re-seeding through ``drive_wave``;
* :mod:`~repro_torch.analytics.eccentricity` — eccentricity, diameter and
  radius via iFUB sweeps batched through the fixed-cohort engine;
* :mod:`~repro_torch.analytics.closeness` — exact and sampled closeness
  centrality as a reduction over wave level channels.

Betweenness, SSSP and PageRank need the weighted tile kernels
(``bvss_spmm_w``, ``bvss_spmm_t``, ``bvss_spmm_minplus``) and come with
their own slices.  All functions speak the id space of the problem/graph
they are handed; ``repro_torch.serve.GraphSession`` layers the caller-id
contract and the symmetrised problem on top.
"""
from repro_torch.analytics.closeness import (closeness_centrality,
                                             closeness_from_levels)
from repro_torch.analytics.components import connected_components
from repro_torch.analytics.eccentricity import (ExtremesReport,
                                                eccentricities,
                                                ifub_extremes)

__all__ = ["closeness_centrality", "closeness_from_levels",
           "connected_components", "eccentricities", "ifub_extremes",
           "ExtremesReport"]
