"""Serving tier of the PyTorch port: :class:`GraphSession` (wave serving
and the analytics verbs that are wave clients)."""
from repro_torch.serve.graph_session import GraphSession

__all__ = ["GraphSession"]
