"""Shared fixtures. NOTE: no XLA_FLAGS here on purpose — unit/smoke tests see
the real single CPU device; multi-device SPMD tests spawn subprocesses with
--xla_force_host_platform_device_count set (see test_distributed.py).

Hypothesis guard: property tests use ``hypothesis`` when available, but the
suite must *collect* (and every example-based test must run) without it.
When the package is absent we install a minimal stand-in module whose
``@given`` replaces the test with a skip, so hypothesis-marked tests report
as skipped instead of exploding module import for their whole file.
"""

import sys

import numpy as np
import pytest

try:
    import hypothesis  # noqa: F401
except ImportError:  # pragma: no cover - exercised only without the dep
    import types

    class _OpaqueStrategy:
        """Accepts any strategy-combinator usage (st.lists(st.integers()),
        st.composite, ...) and returns itself."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

    def _given(*_args, **_kwargs):
        def deco(fn):
            def skipper():
                pytest.skip("hypothesis not installed "
                            "(pip install -r requirements-dev.txt)")

            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            return skipper

        return deco

    def _settings(*_args, **_kwargs):
        if _args and callable(_args[0]):  # bare @settings
            return _args[0]
        return lambda fn: fn

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _OpaqueStrategy()
    _hyp.HealthCheck = _OpaqueStrategy()
    _hyp.assume = lambda *a, **k: True
    _hyp.note = lambda *a, **k: None
    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: getattr(_hyp.strategies, name)
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
