"""One less the device's busy time over the wall time of the traced slice."""


def read(rec: dict):
    t = rec.get("trace")
    if not t or not t["levels"] or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
