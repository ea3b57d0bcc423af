"""Recovery strategies of the port: the pluggable policy API.

    from repro_torch.recovery import make_strategy, register_strategy

    strategy = make_strategy(rcfg)           # rcfg.strategy names a policy
    state = strategy.on_failure(state, event)

The counterpart of ``repro.recovery``: ``none``, ``redundant``,
``checkfree``, ``checkfree_plus``, ``uniform``, ``copy`` and ``random``.
The checkpoint, statestore, adaptive and elastic strategies come later
(ROADMAP.md queue 1, items 9-10).
"""
from repro_torch.recovery.base import (FailureContext,  # noqa: F401
                                       RecoveryStrategy)
from repro_torch.recovery.registry import (available_strategies,  # noqa: F401
                                           default_protect_edges,
                                           get_strategy_cls, make_strategy,
                                           register_strategy)

# import for registration side effects: the built-in policies
from repro_torch.recovery import strategies as _strategies  # noqa: F401,E402
