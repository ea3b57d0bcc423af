"""Progress output behind a verbosity knob, mirrored into the event stream
(the counterpart of ``repro.telemetry.log``).

:func:`log` is the port's one sink for progress lines: it prints a message
only when its level clears the verbosity knob, and mirrors every message
into the structured event stream as a ``log`` event when a recorder is
installed, so a run directory keeps the whole narrative even of a quiet run.

Levels: 0 = always (final results), 1 = progress (default), 2 = detail.
The knob is :func:`set_verbosity`; until it is called, the
``REPRO_VERBOSITY`` environment variable, read at each call (1 when unset).
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.telemetry import recorder as _recorder

_VERBOSITY: Optional[int] = None


def verbosity() -> int:
    if _VERBOSITY is not None:
        return _VERBOSITY
    try:
        return int(os.environ.get("REPRO_VERBOSITY", "1"))
    except ValueError:
        return 1


def set_verbosity(level: int) -> int:
    """Set the print threshold; returns the previous value."""
    global _VERBOSITY
    prev, _VERBOSITY = verbosity(), int(level)
    return prev


def log(message: str, *, level: int = 1) -> None:
    """Print ``message`` when ``level <= verbosity()`` and mirror it into
    the event stream when telemetry is enabled."""
    if level <= verbosity():
        print(message, flush=True)
    _recorder.emit("log", message=message, level=level)
