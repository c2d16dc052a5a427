"""Billions of traversed edges a second: the undirected edges of every
completed root's component, summed over the window, over its wall time."""


def read(rec: dict):
    w = rec["window"]
    return rec["traversed_edges"] / w["wall_s"] / 1e9 if w["wall_s"] > 0 else None
