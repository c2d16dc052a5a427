"""The port's ``prepare.permute`` and ``prepare.bvss`` spans in set-up: the
graph relabelled by the ordering, the BVSS built and its update scheme
chosen."""

NAMES = ("prepare.permute", "prepare.bvss")


def read(rec: dict):
    spans = (rec.get("spans") or {}).get("setup", {})
    found = [spans[k]["s"] for k in NAMES if k in spans]
    return sum(found) if found else None
