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


def stores_from_jax(pstores, osstores):
    """The reference runtime's chunk stores (``driver.init_state``'s
    ``(pstores, osstores)``, as numpy through ``jax.device_get``) -> the
    port's: the same nesting, shapes and dtypes, as CPU tensors (bf16
    through float32, as :func:`params_from_jax`).  Place them with
    :func:`repro_torch.runtime.driver.place_state`.  Stores at tp > 1
    load as they are, the SSM families' too: each rank's shard has the
    port's tp-local layout.  (The reference draws each rank's shard on
    its own, so they hold a model of their own; a GLOBAL tree goes
    through ``driver.init_state(params=)``, which splits it by the
    port's rule.)"""
    return params_from_jax(pstores), params_from_jax(osstores)
