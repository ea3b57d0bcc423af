"""Carry parameter trees between numpy and the port's tensors.

``params_from_numpy`` takes the JAX package's parameters as a nested dict of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the same
nested dict of tensors: same keys, the stacked block axis kept, so
``Model(cfg, params_from_numpy(tree, device=...))`` serves JAX weights.
``params_to_numpy`` goes back.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart in
        # torch.from_numpy: carry the bits through an int16 view
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    # a copy: arrays from JAX are read-only, which torch does not support
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree: Any, *, device, dtype: Optional[torch.dtype] = None,
                      ) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    ``dtype``, when given, casts every floating leaf.
    """
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    t = _tensor_from_numpy(tree)
    if dtype is not None and torch.is_floating_point(t):
        t = t.to(dtype)
    return t.to(device)


def params_to_numpy(tree: Any) -> Any:
    """Nested dict of tensors -> nested dict of numpy arrays on the host.

    bfloat16 comes back as numpy's ``ml_dtypes.bfloat16``, bit for bit.
    """
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
