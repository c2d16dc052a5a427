from .csr import Graph, from_edges, src_of_edges, to_dense_bits
from . import generators

__all__ = ["Graph", "from_edges", "src_of_edges", "to_dense_bits",
           "generators"]
