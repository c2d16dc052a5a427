"""``wave``: one closed-loop client sends a batch of ``roots_per_batch``
roots to ``GraphSession.levels_batch`` and waits for every answer (host
level arrays in the caller's ids) before it sends the next batch.  The
session's wave pool has ``slots`` columns."""
from __future__ import annotations


def roots_per_call(mix: dict) -> int:
    return int(mix["roots_per_batch"])


def slots(mix: dict) -> int:
    return int(mix["slots"])


def serve(session, roots) -> list:
    return session.levels_batch([int(r) for r in roots])
