"""The port's analytics launcher (``repro_torch.launch.analytics``) on the
CPU, against the reference launcher's verbs, fields and flags.

With ``--device cpu`` every verb of ``WHAT`` runs, and every verb but
``extremes`` (which the reference prints unchecked) ends in the
``VERIFIED`` suffix of the oracle that ran, at the reference's
tolerances.  The first line carries the reference's fields with the values
its own host pipeline gives (ordering and update scheme); unknown
``--what`` entries are an argparse error; ``--devices 2`` serves every
verb on a mesh of two gloo ranks; without ``--device cpu`` the launcher
asks for the card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import build_bvss as jbuild_bvss
from repro.core.ordering import auto_order as jauto_order
from repro.core.policy import choose_update_scheme as jchoose_scheme
from repro.launch import analytics as janalytics
from repro.launch import bfs as jlaunch
from repro_torch.errors import ConfigError
from repro_torch.launch import analytics as tanalytics
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SUFFIX = {"components": "; VERIFIED vs scipy",
          "eccentricity": "; VERIFIED vs scipy",
          "betweenness": "; VERIFIED vs Brandes oracle",
          "closeness": "; VERIFIED vs scipy",
          "sssp": "; VERIFIED vs scipy",
          "pagerank": "; VERIFIED vs float64 power iteration"}


def verb_lines(lines):
    """{verb: its output line}, from the ``[analytics] <verb>`` prefixes."""
    out = {}
    for line in lines[1:]:
        head = line.removeprefix("[analytics] ").split(":")[0]
        out[head.split(" ")[0]] = line
    return out


def fields(line):
    return dict(tok.split("=", 1) for tok in line.split()[1:] if "=" in tok)


def test_what_matches_reference():
    assert tanalytics.WHAT == janalytics.WHAT
    assert set(SUFFIX) | {"extremes"} == set(janalytics.WHAT)


@pytest.mark.parametrize("graph", ["rmat", "road"])
def test_cli_verifies_every_verb_on_cpu(graph, capsys):
    tanalytics.main(["--graph", graph, "--scale", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    verbs = verb_lines(lines)
    assert list(verbs) == list(janalytics.WHAT)
    for verb, line in verbs.items():
        if verb == "extremes":
            assert "VERIFIED" not in line and "EXACT" in line, line
        else:
            assert line.endswith(SUFFIX[verb]), line
    # the first line: the reference's fields, with the values of the
    # reference's own host pipeline on the same graph
    g = jlaunch.build_graph(graph, 8, 0)
    perm, kind = jauto_order(g, w=512)
    want = {"graph": graph, "n": str(g.n), "m": str(g.m), "ordering": kind,
            "engine": jchoose_scheme(jbuild_bvss(g.permute_fast(perm))),
            "max_batch": "8"}
    got = fields(lines[0])
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cpu"


@pytest.mark.parametrize("verb", janalytics.WHAT)
def test_cli_single_verb(verb, capsys):
    tanalytics.main(["--graph", "clustered", "--scale", "7", "--what", verb,
                     "--sources", "3", "--max-batch", "2", "--seed", "5",
                     "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "max_batch=2" in lines[0]
    (line,) = verb_lines(lines).values()
    assert line.startswith(f"[analytics] {verb}")
    assert line.endswith(SUFFIX.get(verb, "ms")), line


def test_cli_no_verify_prints_no_suffix(capsys):
    tanalytics.main(["--graph", "road", "--scale", "6", "--no-verify",
                     "--what", "components,sssp", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert not any("VERIFIED" in line for line in lines)


def test_unknown_what_is_an_argparse_error(capsys):
    with pytest.raises(SystemExit) as exc:
        tanalytics.main(["--what", "components,diameter", "--device", "cpu"])
    assert exc.value.code == 2
    assert "unknown --what entries ['diameter']" in capsys.readouterr().err


def test_devices_waits_for_the_mesh_slice():
    """``--devices 2`` (once refused, queue 1 item 11d) serves every verb
    through a session on a mesh of two spawned gloo ranks: rank 0 prints
    once, and every verb but ``extremes`` ends in its oracle's suffix."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analytics", "--graph",
         "road", "--scale", "6", "--device", "cpu", "--devices", "2",
         "--sources", "4"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].endswith("device=cpu mesh=2x1"), lines
    got = verb_lines(lines)
    assert sorted(got) == sorted(tanalytics.WHAT), lines
    for verb, suffix in SUFFIX.items():
        assert got[verb].endswith(suffix), got[verb]


def test_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        tanalytics.main(["--graph", "road", "--scale", "6"])

