"""Runtime enforcement of the invariants the static rules guard.

The counterpart of ``repro.analysis.runtime``.  The static pass
(``repro_torch.analysis.rules``) proves the *code shape*; this module
enforces the *execution*:

* :func:`sync_free` — fails the enclosed block on any **implicit**
  device-to-host read (``float(t)``, ``.item()``, ``.tolist()``,
  ``np.asarray(t)``, ``if t:``).  The explicit drain,
  :func:`device_get` (``repro_torch.tree.device_get``, the counterpart of
  ``jax.device_get``), stays legal: that is the fused hot path's contract,
  one explicit drain per window and no hidden sync.
* :func:`guarded` — the context the pytest plugin wraps marked tests in.
  JAX's ``guarded`` is ``sync_free`` plus ``no_tracer_leaks``
  (``jax.checking_leaks``).  Eager PyTorch has no tracers, so nothing can
  leak from a trace and ``no_tracer_leaks`` has no counterpart: here
  ``guarded`` is :func:`sync_free`.
* :func:`captured_graph_count` / :func:`assert_capture_bound` — the capture
  sentinel, the counterpart of JAX's retrace sentinel.  JAX compiles one
  executable per window bucket; the port captures one step as a CUDA graph
  and replays it for every window size (``core/window.py``), so the bound is
  one capture per stage partition the run used (1, plus one per elastic
  re-layout), whatever ``Trainer.dispatched_buckets`` holds.  On the CPU,
  and for windows built with ``graphs=False``, the count is 0.

``sync_free`` is two layers deep, as JAX's is:

* **On the CPU** every tensor is host memory, so no read synchronizes and
  nothing would ever trip.  For the length of the block the host-conversion
  entry points of ``torch.Tensor`` (``__float__``, ``__int__``,
  ``__bool__``, ``__index__``, ``__complex__``, ``__array__``, ``item``,
  ``tolist``, ``numpy``) raise :class:`ImplicitHostSyncError` unless an
  explicit section (:func:`repro_torch.tree.explicit`) is open on the
  calling thread.  The layer cannot tell host data from device data, so
  host-side numbers must be numpy or Python numbers, not CPU tensors, as
  JAX's trainer keeps them.  The blocker is not narrowed to the port's own
  frames.  The one call of PyTorch's own code that trips it on the
  trainer's path, ``nn.init.trunc_normal_``'s ``.item()`` of a CPU scalar
  it makes itself (no sync on the card either), runs in the parameter
  draw, which the trainer does in its explicit set-up section
  (``Trainer.run``).  The patch is process-global while active: use it
  around a region under test, not around code that converts tensors on
  other threads.
* **On the card** it also sets ``torch.cuda.set_sync_debug_mode("error")``,
  so every synchronizing CUDA call raises, and restores the previous mode
  on exit; an explicit section lifts the mode for its own length.

Nested regions share one patch and one mode (the outermost installs and
removes them).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

from repro_torch.tree import (device_get, explicit, explicit_counts,  # noqa: F401
                              in_explicit_section)

# host-conversion entry points of torch.Tensor
_CONVERSIONS = ("__float__", "__int__", "__bool__", "__index__",
                "__complex__", "__array__", "item", "tolist", "numpy")

_PATCH_LOCK = threading.Lock()
_PATCH_DEPTH = 0                    # nested sync_free regions share patches
_SAVED: dict = {}                   # name -> (own attribute?, original)
_MODE: dict = {}                    # the card's sync debug mode before


class ImplicitHostSyncError(RuntimeError):
    """An implicit device->host read inside a sync_free() region."""


def _make_blocker(name, orig):
    def blocker(self, *args, **kwargs):
        if in_explicit_section():
            return orig(self, *args, **kwargs)
        raise ImplicitHostSyncError(
            f"implicit device->host read via `{name}` inside a sync_free() "
            f"region; drain explicitly with repro_torch.tree.device_get at "
            f"the window boundary instead")
    blocker.__name__ = getattr(orig, "__name__", name)
    return blocker


def _install_patches() -> None:
    for name in _CONVERSIONS:
        orig = getattr(torch.Tensor, name)
        _SAVED[name] = (name in torch.Tensor.__dict__,
                        torch.Tensor.__dict__.get(name))
        setattr(torch.Tensor, name, _make_blocker(name, orig))
    if torch.cuda.is_available():
        _MODE["prev"] = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")


def _remove_patches() -> None:
    for name in _CONVERSIONS:
        own, orig = _SAVED.pop(name)
        if own:
            setattr(torch.Tensor, name, orig)
        else:
            delattr(torch.Tensor, name)
    if "prev" in _MODE:
        torch.cuda.set_sync_debug_mode(_MODE.pop("prev"))


@contextlib.contextmanager
def sync_free() -> Iterator[None]:
    """Disallow *implicit* device->host reads inside the block.

    :func:`device_get` remains allowed (it is the explicit drain);
    ``float(t)``, ``np.asarray(t)``, ``.item()`` and friends raise
    :class:`ImplicitHostSyncError`, and on the card any synchronizing CUDA
    call raises PyTorch's own error.  Host-to-device copies from pinned
    memory (feeding batches) are untouched.
    """
    global _PATCH_DEPTH
    with _PATCH_LOCK:
        if _PATCH_DEPTH == 0:
            _install_patches()
        _PATCH_DEPTH += 1
    try:
        yield
    finally:
        with _PATCH_LOCK:
            _PATCH_DEPTH -= 1
            if _PATCH_DEPTH == 0:
                _remove_patches()


@contextlib.contextmanager
def guarded() -> Iterator[None]:
    """The full runtime guard: :func:`sync_free` (eager PyTorch has no
    tracers to leak, so there is no leak check to add)."""
    with sync_free():
        yield


def captured_graph_count(trainer) -> int:
    """CUDA graphs the trainer's fused windows captured over the run, the
    windows of earlier stage partitions included (0 on the CPU and for
    windows without graphs)."""
    window = trainer.window
    return window.prior_captures + window.captures


def assert_capture_bound(trainer, expected: int,
                         what: str = "fused window") -> None:
    """Assert that the trainer's windows captured exactly ``expected``
    graphs: one per stage partition the run used.  More means the step was
    captured again (a graph reset, a shape that changed), each capture a
    synchronize and a new private pool."""
    got = captured_graph_count(trainer)
    assert got == expected, (
        f"{what} captured {got} graph(s), expected exactly {expected} (one "
        f"per stage partition; window sizes replay one graph); extra "
        f"captures are silent re-captures of the step")
