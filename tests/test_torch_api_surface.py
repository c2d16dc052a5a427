"""The port's public façade against the reference's snapshot.

``tests/api_surface.txt`` renders every name the ``repro`` façade exports,
with the parameter shape of every public callable (and of public methods
one level deep).  The port must export each of those names, and each must
render the same through the snapshot's own renderer
(``tests/test_api_surface.py``), except for these listed divergences:

* the ``device`` parameter, which the port adds (its entry points run on
  the card unless the caller asks for the CPU);
* none for the mesh: since the sharded waves were ported, the ``mesh``
  and ``mesh_axis`` parameters of ``GraphSession`` and
  ``GraphSessionManager.open_session`` and ``GraphSession.mesh`` are
  compared like the rest (``LATER_SLICE_PARAMS`` and
  ``DIVERGENT_MEMBERS`` are empty);
* ``PreparedBFS``'s field order: the port's ``device`` field sits before
  ``_fn``, so the fields compare as a set of names;
* the name of ``prepare``'s keyword catch-all (``**legacy`` in the
  reference, a deprecated spelling; ``**fields`` in the port, field
  overrides of the options).

The snapshot itself is the reference's and is not regenerated here.
"""
from __future__ import annotations

import inspect
import re

import pytest

import repro_torch
from tests.test_api_surface import SNAPSHOT, _class_lines, _params
from torch_one_thread import one_torch_thread  # noqa: F401

#: parameters that differ by design (see the module docstring)
DIVERGENT_PARAMS = ("device",)
#: parameters that come with a later slice, by the line they are on
LATER_SLICE_PARAMS: dict[str, tuple[str, ...]] = {}
#: members that come with a later slice
DIVERGENT_MEMBERS: tuple[str, ...] = ()
#: classes whose fields compare as a set of names
UNORDERED = ("PreparedBFS",)


def snapshot_lines() -> list[str]:
    with open(SNAPSHOT) as f:
        return [ln.rstrip("\n") for ln in f if not ln.startswith("#")]


def render(name: str) -> list[str]:
    """The port's lines for façade name ``name``, as the snapshot's
    renderer would write them."""
    obj = getattr(repro_torch, name)
    if name == "__version__":
        return [f"__version__: {type(obj).__name__}"]
    if name == "VERBS":
        return [f"VERBS: tuple {tuple(obj)}"]
    if inspect.isclass(obj):
        return _class_lines(name, obj)
    if callable(obj):
        return [f"{name}: function {_params(obj)}"]
    return [f"{name}: {type(obj).__name__}"]


def normalise(line: str) -> str:
    """Drop the divergent parameters and the catch-all's name; order the
    fields of the unordered classes."""
    head, sep, params = line.partition(" (")
    if not sep:
        return line
    parts = [p for p in params.rstrip(")").split(", ") if p]
    excused = DIVERGENT_PARAMS + LATER_SLICE_PARAMS.get(head.split(":")[0],
                                                        ())
    parts = [re.sub(r"^\*\*\w+$", "**", p) for p in parts
             if p.split("=")[0] not in excused]
    if head.split(":")[0] in UNORDERED:
        parts = sorted(p.split("=")[0] for p in parts)
    return f"{head} ({', '.join(parts)})"


TOP_NAMES = sorted({ln.split(":")[0].split(".")[0] for ln in snapshot_lines()})


def test_snapshot_lists_the_reference_facade():
    assert len(TOP_NAMES) == 30
    assert {"UpdateReport", "apply_edge_updates", "VERBS", "build_problem",
            "src_of_edges", "__version__"} <= set(TOP_NAMES)


@pytest.mark.parametrize("name", TOP_NAMES)
def test_port_exports_reference_name(name):
    assert name in repro_torch.__all__
    assert getattr(repro_torch, name, None) is not None


@pytest.mark.parametrize("name", TOP_NAMES)
def test_port_surface_equals_reference(name):
    want = [ln for ln in snapshot_lines()
            if ln.split(":")[0].split(".")[0] == name
            and ln.split(":")[0] not in DIVERGENT_MEMBERS]
    got = render(name)
    missing = [ln for ln in map(normalise, want)
               if ln not in map(normalise, got)]
    assert not missing, (name, missing, got)


def test_facade_values_equal_reference():
    assert repro_torch.VERBS == repro_torch.GraphSession.VERBS
    assert isinstance(repro_torch.__version__, str)
    assert len(set(repro_torch.__all__)) == len(repro_torch.__all__)
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name, None) is not None, name
