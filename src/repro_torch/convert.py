"""Bring the reference's parameters into the port.

The parity tests initialise a model once with the JAX package, turn its
param tree into numpy arrays, and hand the same weights to both
packages.  JAX's bf16 arrays come out of numpy as ``ml_dtypes.bfloat16``,
which torch cannot read: they go through float32 (an exact step) and
then to ``torch.bfloat16``."""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree):
    """Reference param tree (nested dicts of numpy arrays) -> the port's
    param tree (nested dicts of CPU tensors, same keys, same dtypes)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))
