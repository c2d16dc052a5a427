"""The port's examples (``examples/torch_quickstart.py``,
``examples/torch_bfs_service.py``) against the reference's
(``examples/quickstart.py``, ``examples/bfs_service.py``).

Each pair runs in process on the same seeded graphs, the port under
``--device cpu``.  What they print is compared with the times left out:
the reachable counts, compressions, ordering and engine, the engine race's
``OK`` lines, the edge update's path and epoch, the post-update levels and
"all verified" exactly; the closeness sample's sources exactly and its
printed mean within the print's resolution (4 decimals).
"""
from __future__ import annotations

import importlib.util
import math
import re
from pathlib import Path

import pytest

from torch_one_thread import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

#: timing fields, blanked before the lines are compared
TIMES = [(re.compile(r"\s+[\d.]+ ms\b"), " <ms>"),
         (re.compile(r"preprocess=[\d.]+s"), "preprocess=<s>"),
         (re.compile(r"sequential [\d.]+s, queued [\d.]+s"),
          "sequential <s>, queued <s>"),
         (re.compile(r"mid-flight, [\d.]+x,"), "mid-flight, <x>,"),
         (re.compile(r"waves\): [\d.]+s,"), "waves): <s>,")]
MEAN = re.compile(r"mean=([\d.]+)$")


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(capsys, run) -> list[str]:
    capsys.readouterr()
    run()
    lines = capsys.readouterr().out.strip().splitlines()
    for pattern, blank in TIMES:
        lines = [pattern.sub(blank, ln) for ln in lines]
    return lines


@pytest.mark.parametrize("ref,port", [
    ("quickstart.py", "torch_quickstart.py"),
    ("bfs_service.py", "torch_bfs_service.py")],
    ids=["quickstart", "bfs_service"])
def test_example_prints_the_reference_answers(capsys, ref, port):
    want = printed(capsys, load(ref).main)
    got = printed(capsys, lambda: load(port).main(["--device", "cpu"]))
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        mg, mw = MEAN.search(g), MEAN.search(w)
        if mw:      # the closeness sample: sources exact, mean within 1e-4
            assert mg and MEAN.sub("", g) == MEAN.sub("", w), (g, w)
            assert math.isclose(float(mg.group(1)), float(mw.group(1)),
                                abs_tol=1e-4), (g, w)
        else:
            assert g == w
    text = "\n".join(got)
    if port == "torch_quickstart.py":
        assert sum(ln.rstrip().endswith(" OK") for ln in got) == 7
        assert "FAIL" not in text
        assert "path=patched epoch=1" in text
    else:
        assert "all verified" in text and "edge update: path=" in text


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_bfs_service.py"])
def test_example_asks_for_the_card_by_default(name):
    """Without ``--device cpu`` an example runs on the card; with no card
    that is a ConfigError, never a quiet CPU run."""
    import torch

    from repro_torch.errors import ConfigError
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default path runs there")
    with pytest.raises(ConfigError, match="no CUDA device"):
        load(name).main([])
