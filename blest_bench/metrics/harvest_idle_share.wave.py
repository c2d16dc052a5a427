"""The traced slice's idle time while the host was in the answers' spans
(``wave.harvest``, ``wave.deliver``, or one inside them), over the slice's
wall time."""

UNDER = {"wave.harvest", "wave.deliver"}


def read(rec: dict):
    t = rec.get("trace")
    if not t or not t["levels"] or t["busy_s"] <= 0 or "idle_under" not in t:
        return None
    return sum(s for path, s in t["idle_under"].items()
               if UNDER & set(path.split("/"))) / t["window_s"]
