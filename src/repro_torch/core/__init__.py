from .bvss import BVSS, BVSSDevice, build_bvss, resolve_device, to_device
from .bfs import (BlestProblem, ENGINES, INF, make_engine, pull_vss_twin,
                  reference_bfs)
from . import ordering

__all__ = ["BVSS", "BVSSDevice", "build_bvss", "resolve_device",
           "to_device", "BlestProblem", "ENGINES", "INF", "make_engine",
           "pull_vss_twin", "reference_bfs", "ordering"]
