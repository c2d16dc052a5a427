"""``single``: one closed-loop client calls ``GraphSession.levels(root)``
for one root at a time (the single-source engine, Table 2's path)."""
from __future__ import annotations


def roots_per_call(mix: dict) -> int:
    return 1


def slots(mix: dict) -> int:
    return int(mix.get("slots", 8))


def serve(session, roots) -> list:
    return [session.levels(int(r)) for r in roots]
