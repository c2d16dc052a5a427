"""The live VSSs over the launched queue width of the wave's pull levels in
the window (the counters ``pull_live`` over ``pull_width``): the rest of
each launch is dummy padding up to the ladder's width."""


def read(rec: dict):
    c = rec["counters"]
    return c["pull_live"] / c["pull_width"] if c.get("pull_width") else None
