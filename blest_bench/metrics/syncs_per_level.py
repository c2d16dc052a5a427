"""Device-to-host copies the wave engine counted (``host_syncs``) over its
lock-step levels, in the window."""


def read(rec: dict):
    c = rec["counters"]
    levels = c["pull_levels"] + c["push_levels"]
    return c["host_syncs"] / levels if levels else None
