"""Share of the device's busy time in the traced slice spent outside the
port's hand-written kernels: the torch gathers, scatters, reductions and
copies beside them."""


def read(rec: dict):
    t = rec.get("trace")
    if not t or not t["levels"] or t["busy_s"] <= 0:
        return None
    return (t["busy_s"] - t["hand_busy_s"]) / t["busy_s"]
