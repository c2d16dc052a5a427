"""Window wall time over the lock-step levels the wave engine ran in it
(its ``pull_levels + push_levels`` counters)."""


def read(rec: dict):
    c = rec["counters"]
    levels = c["pull_levels"] + c["push_levels"]
    return rec["window"]["wall_s"] * 1e3 / levels if levels else None
