"""The ``wave.batch`` spans less the ``wave.copy_wait`` spans, over the wave
engine's lock-step levels, all in the window's rest after the traced slice,
where the profiler costs nothing: the host's own time a level, the blocking
device-to-host copies left out."""


def read(rec: dict):
    spans = (rec.get("spans") or {}).get("rest", {})
    c = rec.get("rest_counters") or {}
    levels = c.get("pull_levels", 0) + c.get("push_levels", 0)
    if "wave.batch" not in spans or not levels:
        return None
    wait = spans.get("wave.copy_wait", {"s": 0.0})["s"]
    return (spans["wave.batch"]["s"] - wait) * 1e3 / levels
