"""Mesh-native BFS on ``torch.distributed`` (DESIGN §2.4), the port of
``repro/distributed``'s BFS half.

The reference runs one program over a JAX mesh under ``shard_map``.  Here
the program is SPMD: one process per rank, each holding one shard on its
own device, and every rank calls the same entry points on the same graph.
A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`, 1-D
``("data",)`` or 2-D ``("data", "col")``, over an initialised process
group: NCCL on CUDA (rank r on ``cuda:r``), gloo on the CPU.

* :mod:`.bfs_dist` — the mesh builders and the flat frontier all-gather;
* :mod:`.collectives` — the butterfly frontier exchange and OR all-reduce
  of the 2-D partition, built from pairwise exchanges, and the per-call
  communication ledger.
"""
from .bfs_dist import (BFS_AXIS, COL_AXIS, bfs_mesh, bfs_mesh2d,
                       frontier_all_gather, mesh_is_2d, mesh_rank_device)
from .collectives import (butterfly_frontier_exchange, butterfly_or_allreduce,
                          comm_ledger, record_comm)

__all__ = ["BFS_AXIS", "COL_AXIS", "bfs_mesh", "bfs_mesh2d",
           "frontier_all_gather", "mesh_is_2d", "mesh_rank_device",
           "butterfly_frontier_exchange", "butterfly_or_allreduce",
           "comm_ledger", "record_comm"]
