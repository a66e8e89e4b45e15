"""Shared inputs of the port's parity tests: one set of weights, made with
numpy from a seed in the reference's param-tree layout, for both the JAX
package and (through ``params_from_jax``) the port."""

import numpy as np


def numpy_params(model, seed: int):
    """Random weights for ``model`` (a reference ``Model``): fan-in
    scaled normals for matrices, 1 + noise for norm weights and biases."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(
                np.float32)
        fan = spec.shape[-1] if "table" in name else spec.shape[-2]
        return (rng.standard_normal(spec.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, model.param_specs())
