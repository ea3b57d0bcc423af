"""Perf levers read from the environment, the counterpart of
``repro.launch.perf``: the same variables mean the same things in both
packages.

* ``REPRO_REMAT`` = ``"nothing"`` (default) | ``"dots"``: the activation
  checkpoint policy of ``forward(..., remat=True)`` (:func:`checkpoint`).
  ``"nothing"`` keeps only a block's inputs and recomputes the whole block
  in the backward (JAX's ``nothing_saveable``).  ``"dots"`` also keeps the
  outputs of the matrix products (``aten.mm``, ``bmm``, ``addmm``) and of
  the flash forward (its ``out`` and ``lse``, the operator
  ``repro_torch::flash_attention_fwd``), which stands in for the attention
  einsums that JAX's ``dots_saveable`` keeps: under ``"dots"`` the flash
  forward is not launched again in the backward.
* ``REPRO_ACT_SHARD`` = ``""`` | ``"feature"`` | ``"seq"``: the axis of a
  (B, S, d) layer-boundary activation that the ``model`` mesh axis splits
  (:func:`activation_spec`).  One card has no mesh, so no model code reads
  it; the dry-run divides the boundary activations' bytes by the model-axis
  size where it is set, which is what the lever does in JAX.

No family draws random numbers in its forward, so the checkpoints keep no
RNG state.
"""
from __future__ import annotations

import functools
import os
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

REMAT_POLICIES = ("nothing", "dots")


def activation_spec() -> Optional[Tuple[Optional[str], ...]]:
    """The axis names of a (B, S, d) boundary activation, or None."""
    mode = os.environ.get("REPRO_ACT_SHARD", "")
    if not mode:
        return None
    if mode == "feature":
        return (None, None, "model")
    if mode == "seq":
        return (None, "model", None)
    raise ValueError(f"REPRO_ACT_SHARD={mode!r}")


def remat_policy() -> str:
    """``REPRO_REMAT``: ``"nothing"`` (default) or ``"dots"``; anything
    else raises."""
    mode = os.environ.get("REPRO_REMAT", "nothing")
    if mode not in REMAT_POLICIES:
        raise ValueError(f"REPRO_REMAT={mode!r}")
    return mode


def _saved_ops():
    aten = torch.ops.aten
    # importing the kernel module registers its operator
    from repro_torch.kernels import flash_attention  # noqa: F401
    return (aten.mm.default, aten.bmm.default, aten.addmm.default,
            torch.ops.repro_torch.flash_attention_fwd.default)


def _save_dots(saved, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint(fn: Callable[..., Any], *args: Any,
               policy: Optional[str] = None) -> Any:
    """``fn(*args)`` under a non-reentrant activation checkpoint with
    ``policy`` (default: :func:`remat_policy`)."""
    policy = remat_policy() if policy is None else policy
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_save_dots, _saved_ops()))
    elif policy != "nothing":
        raise ValueError(f"remat policy {policy!r}")
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
