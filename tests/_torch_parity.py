"""Shared inputs of the port's parity tests: one set of weights, made with
numpy from a seed in the reference's param-tree layout, for both the JAX
package and (through ``params_from_jax``) the port."""

import numpy as np


def numpy_params(model, seed: int):
    """Random weights for ``model`` (a reference ``Model``): fan-in
    scaled normals for matrices, 1 + noise for norm weights and biases,
    and Mamba2's per-head leaves in their useful range: ``A_log`` the log
    of a decay rate in [1, 16], ``dt_bias`` the inverse softplus of a
    step in [1e-3, 0.1] (log-uniform), ``D`` 1 + noise."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        name = jax.tree_util.keystr(path)
        last = getattr(path[-1], "key", None)
        if last == "A_log":
            return np.log(rng.uniform(1, 16, spec.shape)).astype(np.float32)
        if last == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), spec.shape))
            return np.log(np.expm1(dt)).astype(np.float32)
        if "norm" in name or last == "D":
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
