"""Shared test configuration.

Four test modules use ``hypothesis`` property tests.  The library is a
dev-only dependency (see ``requirements-dev.txt``); when it is absent we
install a minimal deterministic shim *before* collection so the suite
still runs: ``@given`` draws a fixed, seeded sample of examples instead
of hypothesis' adaptive search.  The shim covers exactly the API surface
the tests use (``given``, ``settings``, ``strategies.integers``,
``strategies.sampled_from``).

``require_devices`` guards the sharded-parity tests: they SKIP on a
plain single-device checkout (the simulated-device flag binds at backend
init, so an in-process pytest run cannot grow devices), but FAIL —
loudly, not silently skip — when ``BLEST_REQUIRE_MULTIDEVICE`` is set,
which the CI multidevice job does.  That turns "the parity suite ran
with 0 skips" into an enforced property instead of a hope: if the
XLA_FLAGS plumbing ever breaks, CI goes red instead of green-but-empty.
"""
from __future__ import annotations

import os
import random
import sys
import types

import pytest


def require_devices(n: int = 2) -> None:
    """Call at the top of a multi-device test body: skip locally when the
    process has fewer than ``n`` devices, FAIL under
    ``BLEST_REQUIRE_MULTIDEVICE=1`` (the CI multidevice job)."""
    import jax
    have = len(jax.devices())
    if have >= n:
        return
    msg = (f"needs >= {n} devices, have {have} (run under XLA_FLAGS="
           f"--xla_force_host_platform_device_count={n})")
    if os.environ.get("BLEST_REQUIRE_MULTIDEVICE"):
        pytest.fail(
            "BLEST_REQUIRE_MULTIDEVICE is set but the device-count "
            "prerequisite is unmet — the multidevice CI job must run the "
            "sharded-parity suite, never skip it: " + msg)
    pytest.skip(msg)

_SHIM_SEED = 0xB1E57  # deterministic: same examples every run
_SHIM_MAX_EXAMPLES = 10  # cap so the fallback stays CI-fast


def _install_hypothesis_shim() -> None:
    try:
        import hypothesis  # noqa: F401
        return  # real library present — use it
    except ImportError:
        pass

    mod = types.ModuleType("hypothesis")
    st = types.ModuleType("hypothesis.strategies")
    mod.__shim__ = True

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def integers(min_value: int, max_value: int) -> _Strategy:
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def sampled_from(elements) -> _Strategy:
        seq = list(elements)
        return _Strategy(lambda rng: seq[rng.randrange(len(seq))])

    def given(**strategies):
        def deco(f):
            # NOTE: plain (*args, **kwargs) signature on purpose — pytest
            # must not mistake the drawn parameters for fixtures.
            def wrapper(*args, **kwargs):
                n = min(getattr(wrapper, "_max_examples",
                                _SHIM_MAX_EXAMPLES), _SHIM_MAX_EXAMPLES)
                rng = random.Random(_SHIM_SEED)
                for _ in range(n):
                    drawn = {k: s.draw(rng) for k, s in strategies.items()}
                    f(*args, **drawn, **kwargs)
            wrapper.__name__ = f.__name__
            wrapper.__doc__ = f.__doc__
            wrapper.__module__ = f.__module__
            return wrapper
        return deco

    def settings(max_examples: int = _SHIM_MAX_EXAMPLES, deadline=None, **_):
        def deco(f):
            f._max_examples = max_examples
            return f
        return deco

    st.integers = integers
    st.sampled_from = sampled_from
    mod.strategies = st
    mod.given = given
    mod.settings = settings
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st


_install_hypothesis_shim()


def pytest_configure(config) -> None:
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels have no CPU mode); skips without one")
