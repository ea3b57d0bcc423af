"""Recovery strategies of the port: the pluggable policy API.

    from repro_torch.recovery import make_strategy, register_strategy

    strategy = make_strategy(rcfg)           # rcfg.strategy names a policy
    state = strategy.on_failure(state, event)

The counterpart of ``repro.recovery``: ``none``, ``redundant``,
``checkfree``, ``checkfree_plus``, ``elastic``, ``uniform``, ``copy``,
``random``, ``checkpoint`` and ``adaptive``, and from
``repro_torch.statestore`` ``tiered_ckpt`` and ``neighbor``.
"""
from repro_torch.recovery.base import (FailureContext,  # noqa: F401
                                       RecoveryStrategy)
from repro_torch.recovery.registry import (available_strategies,  # noqa: F401
                                           default_protect_edges,
                                           get_strategy_cls, make_strategy,
                                           register_strategy)

# import for registration side effects: the built-in policies
from repro_torch.recovery import strategies as _strategies  # noqa: F401,E402
from repro_torch.recovery import adaptive as _adaptive  # noqa: F401,E402
# ... and the statestore-backed ones (tiered_ckpt / neighbor)
from repro_torch import statestore as _statestore  # noqa: F401,E402
