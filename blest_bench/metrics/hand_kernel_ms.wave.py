"""Device time of the port's hand-written kernels in the traced slice over
the wave engine's levels there.  Nothing is read unless the profiler saw
exactly the launches the port counted (``launch_counts()``)."""


def read(rec: dict):
    t = rec.get("trace")
    if not t or not t["levels"] or not t["hand_events"] \
            or t["hand_events"] != t["hand_launches"]:
        return None
    return t["hand_busy_s"] * 1e3 / t["levels"]
