"""The port's ``prepare.order`` span in set-up: the ordering (RCM or the
Jaccard windows) that ``GraphSession(...)`` picks for the graph."""


def read(rec: dict):
    spans = (rec.get("spans") or {}).get("setup", {})
    return spans["prepare.order"]["s"] if "prepare.order" in spans else None
