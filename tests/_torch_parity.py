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


def reference_hardware():
    """The port's ``Hardware`` record built from the reference's own
    roofline constants, so the port's cost model and timeline price the
    same seconds as the reference's."""
    from repro.analysis import roofline
    from repro_torch.analysis.roofline import Hardware

    return Hardware(
        name="reference roofline constants",
        peak_flops=roofline.PEAK_FLOPS, hbm_bw=roofline.HBM_BW,
        h2d_bw=roofline.HOST_LINK_BW, d2h_bw=roofline.HOST_LINK_BW,
        slow_bw=roofline.NVME_BW, collective_bw=roofline.ICI_BW)


def timeline_fields(tl) -> dict:
    """A ``StepTimeline`` of either package as a plain dict (the two
    dataclasses never compare equal to each other directly)."""
    import dataclasses

    return None if tl is None else dataclasses.asdict(tl)
