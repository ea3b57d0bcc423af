"""Training-loop state containers, shared by the trainer and the recovery
strategies (kept free of trainer imports so ``repro_torch.recovery`` can
construct :class:`TrainState` without a cycle).

The counterpart of ``repro.core.state``.  ``omegas`` stays on the device (a
(num_stages,) fp32 tensor), so the step loop copies nothing to the host for
it; :class:`History` holds host numbers only.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.optim.adam import OptState

Params = Any


@dataclass
class TrainState:
    params: Params
    opt_state: OptState
    lr_scale: float = 1.0
    omegas: Optional[torch.Tensor] = None    # last per-stage ||grad||^2
    effective_step: int = 0                  # optimization progress


@dataclass
class History:
    steps: List[int] = field(default_factory=list)
    wall_time: List[float] = field(default_factory=list)
    loss: List[float] = field(default_factory=list)
    eval_loss: List[Tuple[int, float, float]] = field(default_factory=list)
    failures: List[Tuple[int, int]] = field(default_factory=list)
    recovery_errors: List[Tuple[int, float]] = field(default_factory=list)
    wall_iters: int = 0
    dispatches: int = 0          # step dispatches; the eager loop has
                                 # dispatches == wall_iters
    truncated: bool = False      # hit the trainer's max_wall safety bound
                                 # before reaching the target step count

    # ---- serialization -----------------------------------------------
    def to_json(self) -> str:
        """JSON round-trip partner of :meth:`from_json` (every field; the
        tuple-valued series become arrays)."""
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "History":
        d = json.loads(s)
        return cls(
            steps=list(d.get("steps", [])),
            wall_time=list(d.get("wall_time", [])),
            loss=list(d.get("loss", [])),
            eval_loss=[tuple(x) for x in d.get("eval_loss", [])],
            failures=[tuple(x) for x in d.get("failures", [])],
            recovery_errors=[tuple(x)
                             for x in d.get("recovery_errors", [])],
            wall_iters=int(d.get("wall_iters", 0)),
            dispatches=int(d.get("dispatches", 0)),
            truncated=bool(d.get("truncated", False)),
        )
