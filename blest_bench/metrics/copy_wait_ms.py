"""The ``wave.copy_wait`` spans, around each blocking device-to-host copy
that the engine counts in ``host_syncs``, over the wave engine's lock-step
levels, both in the window's rest after the traced slice, where the
profiler costs nothing."""


def read(rec: dict):
    spans = (rec.get("spans") or {}).get("rest", {})
    c = rec.get("rest_counters") or {}
    levels = c.get("pull_levels", 0) + c.get("push_levels", 0)
    if "wave.copy_wait" not in spans or not levels:
        return None
    return spans["wave.copy_wait"]["s"] * 1e3 / levels
