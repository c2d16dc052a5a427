from .csr import Graph, from_edges, src_of_edges
from . import generators

__all__ = ["Graph", "from_edges", "src_of_edges", "generators"]
