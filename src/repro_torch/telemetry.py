"""Progress output of the port's command-line tools behind a verbosity knob.

The port's own counterpart of ``repro.telemetry.log`` (printing only; the
event stream, metrics and trace spans come later in the port).
Levels: 0 = always (final results), 1 = progress (default), 2 = detail.
The knob is the ``REPRO_VERBOSITY`` environment variable, read per call.
"""
from __future__ import annotations

import os


def verbosity() -> int:
    try:
        return int(os.environ.get("REPRO_VERBOSITY", "1"))
    except ValueError:
        return 1


def log(message: str, *, level: int = 1) -> None:
    """Print ``message`` when ``level <= verbosity()``."""
    if level <= verbosity():
        print(message, flush=True)
