"""Strategy registry: config string -> RecoveryStrategy instance.

    @register_strategy("my_policy")
    class MyPolicy(RecoveryStrategy):
        ...

    strategy = make_strategy(rcfg)          # rcfg.strategy == "my_policy"

The counterpart of ``repro.recovery.registry``.  Registration is
import-time; ``repro_torch.recovery.__init__`` imports the built-in module so
every config-selectable name is present as soon as the package is.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type, TYPE_CHECKING

from repro_torch.recovery.base import RecoveryStrategy

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.config import RecoveryConfig
    from repro_torch.core.walltime import WallClockModel

_REGISTRY: Dict[str, Type[RecoveryStrategy]] = {}


def register_strategy(name: str) -> Callable[[Type[RecoveryStrategy]],
                                             Type[RecoveryStrategy]]:
    def deco(cls: Type[RecoveryStrategy]) -> Type[RecoveryStrategy]:
        assert issubclass(cls, RecoveryStrategy), cls
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"strategy {name!r} already registered "
                             f"({_REGISTRY[name].__name__})")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_strategies() -> List[str]:
    return sorted(_REGISTRY)


def default_protect_edges(name: str) -> bool:
    """The paper's protocol: edge stages are protected for every policy
    without swap-trained twins — only CheckFree+'s swap schedule makes
    S_first/S_last losable.  Every launcher derives its
    ``protect_edge_stages`` default from this."""
    return not get_strategy_cls(name).uses_swap_schedule


def get_strategy_cls(name: str) -> Type[RecoveryStrategy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown recovery strategy {name!r}; available: "
                       f"{available_strategies()}") from None


def make_strategy(rcfg: "RecoveryConfig",
                  wall: Optional["WallClockModel"] = None) -> RecoveryStrategy:
    """Instantiate the strategy named by ``rcfg.strategy``.

    Construction is side-effect-free, so this is also safe to use for pure
    cost queries — ``WallClockModel``'s string API delegates here.
    """
    if wall is None:
        from repro_torch.core.walltime import WallClockModel
        wall = WallClockModel(iter_time_s=rcfg.iteration_time_s)
    return get_strategy_cls(rcfg.strategy)(rcfg, wall)
