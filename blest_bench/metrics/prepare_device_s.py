"""The port's ``prepare.device`` and ``session.bind`` spans in set-up: the
problem uploaded and the engine built, then the wave pool bound."""

NAMES = ("prepare.device", "session.bind")


def read(rec: dict):
    spans = (rec.get("spans") or {}).get("setup", {})
    found = [spans[k]["s"] for k in NAMES if k in spans]
    return sum(found) if found else None
