"""The port's ``kernels.build`` (only where nvcc runs) and ``kernels.load``
spans in set-up: the hand kernels' libraries compiled and loaded.  The
CPU twins load none, so there it reads nothing."""

NAMES = ("kernels.build", "kernels.load")


def read(rec: dict):
    spans = (rec.get("spans") or {}).get("setup", {})
    found = [spans[k]["s"] for k in NAMES if k in spans]
    return sum(found) if found else None
