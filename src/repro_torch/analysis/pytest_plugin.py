"""Pytest integration of the port's runtime guard (the counterpart of
``repro.analysis.pytest_plugin``).

Load it with ``-p repro_torch.analysis.pytest_plugin`` (or import it from a
``conftest.py``).  Tests then opt in per item:

* ``@pytest.mark.torch_runtime_guard`` — run the test under
  :func:`repro_torch.analysis.runtime.guarded`: any *implicit* device->host
  read fails the test.  The explicit drain (``device_get``) stays legal.
* ``@pytest.mark.torch_sync_free`` — the same under
  :func:`repro_torch.analysis.runtime.sync_free` (``guarded`` is
  ``sync_free`` in the port: eager PyTorch has no tracers to leak).
* fixture ``torch_runtime_guard`` — the :mod:`repro_torch.analysis.runtime`
  module, for tests that guard a *region* rather than the whole test::

      def test_hot_path(torch_runtime_guard):
          with torch_runtime_guard.sync_free():
              trainer.run(...)

The names differ from the JAX plugin's (``runtime_guard``, ``sync_free``)
so that both plugins load in one session without a clash.  Opt-in rather
than blanket: plenty of tests read scalars off the device in asserts.
"""
from __future__ import annotations

import pytest

from repro_torch.analysis import runtime as _runtime

_MARKER_DOCS = {
    "torch_runtime_guard": (
        "torch_runtime_guard: run under repro_torch.analysis.runtime."
        "guarded() — implicit device->host reads fail the test"
    ),
    "torch_sync_free": (
        "torch_sync_free: run under repro_torch.analysis.runtime."
        "sync_free() — implicit device->host reads fail the test"
    ),
}


def pytest_configure(config):
    for line in _MARKER_DOCS.values():
        config.addinivalue_line("markers", line)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if item.get_closest_marker("torch_runtime_guard") is not None:
        with _runtime.guarded():
            return (yield)
    if item.get_closest_marker("torch_sync_free") is not None:
        with _runtime.sync_free():
            return (yield)
    return (yield)


@pytest.fixture
def torch_runtime_guard():
    """The repro_torch.analysis.runtime module, for region-scoped guarding."""
    return _runtime
