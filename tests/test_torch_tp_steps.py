"""The port's chunked runtime stepping at dp 2 x tp 2 against the
reference's runtime from its own ``init_state`` stores (taken as they
are by ``stores_from_jax``) on the CPU, the stores compared part by part
and the replicated copies bitwise equal across ranks, and every
family's runtime built at tp > 1 and with pods (``tests/_torch_tp.py``
sets out the gradient scale and the tolerances; pods and the conversion
are in ``test_torch_tp_pods.py``)."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.runtime import driver as jax_driver  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402

import _torch_tp as H  # noqa: E402

B, S = H.B, H.S


def test_tp2_dp2_steps_match_reference_stores():
    """dp 2 x tp 2 (qwen2.5 smoke), 2 steps from the reference's
    ``init_state`` stores: losses within 1e-5 of the reference's step,
    every store part as the single-device runtime test holds it, and
    every replicated leaf's copies (params, p32, m, v) bitwise equal
    across the model ranks."""
    jrt, rt = H.runtimes("qwen2.5-3b", 2, 2)
    H.oracle_scale(jrt, 2)
    losses, ref, got = H.run_both(jrt, rt, H.batches(rt.cfg, 2))
    for jl, tl, _, _ in losses:
        assert abs(tl - jl) <= 1e-5 * abs(jl), (jl, tl)
    H.check_stores(ref, got, 2)
    assert H.replicated_equal(rt, *got) > 0
    assert all(m["collectives"]["tp_bytes"] > 0 for m in [
        driver.build_train_step(rt, InputShape("t", S, B, "train"))[0](
            *got, H.batches(rt.cfg, 1)[0], 2)[2]])




FAMILIES = ["qwen3-0.6b", "qwen2.5-3b", "gpt2-paper-1b", "deepseek-7b",
            "nemotron-4-340b", "mixtral-8x7b", "deepseek-v2-lite-16b",
            "whisper-large-v3", "phi-3-vision-4.2b", "zamba2-1.2b",
            "xlstm-1.3b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_builds_at_tp(arch):
    """``make_smoke_mesh(2, 2)``, ``(1, 4)`` and ``(1, 2, pods=2)`` build a
    runtime for every family, its layouts and store shapes the
    reference's field for field and its batch axes the reference's."""
    for dp, tp, pods in ((2, 2, 1), (1, 4, 1), (1, 2, 2)):
        jrt, rt = H.runtimes(arch, dp, tp, pods)
        for name, lay in rt.layouts.items():
            jlay = jrt.layouts[name]
            assert lay.names == jlay.names and lay.shapes == tuple(
                tuple(s) for s in jlay.shapes), name
            assert rt.store_shape(name) == tuple(
                jrt.store_specs()[name].shape), name
        for b in (1, 2, 4):
            want = jax_driver.batch_axes(jrt, b)
            got = driver.train_batch_specs(rt, InputShape("t", S, b,
                                                          "train"))[1]
            assert got["tokens"][0] == want, (dp, tp, pods, b)
