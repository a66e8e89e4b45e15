"""The port's MoE and MLA at tp = 2 on the chunked runtime against the
reference's on the CPU (deepseek-v2-lite smoke with the "ep" layout),
``moe_combine_first`` at tp > 1, and the training CLI at dp 2 x tp 2
(``tests/_torch_tp.py`` sets out the gradient scale and the
tolerances)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core.engine import to_device_batch  # noqa: E402
from repro_torch.models.layers import AxisCtx  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402

import _torch_tp as H  # noqa: E402


def test_deepseek_ep_mla_tp2_and_combine_first():
    """deepseek-v2-lite smoke at tp = 2 with the "ep" MoE layout (2 of the
    4 experts a rank) and MLA: one step against the reference's (loss,
    aux loss, stores); then ``moe_combine_first`` moves the MoE's psum
    (the summed payloads go from [E, C, d] buffers to combined [T, d]
    rows) and leaves the loss within 5e-5, as the reference's
    ``tests/test_perf_options.py`` holds it."""
    jrt, rt = H.runtimes("deepseek-v2-lite-16b", 1, 2,
                    cfg_kw=dict(moe_impl="ep"))
    H.oracle_scale(jrt, 2)
    losses, ref, got = H.run_both(jrt, rt, H.batches(rt.cfg, 1))
    jl, tl, ja, ta = losses[0]
    assert abs(tl - jl) <= 1e-5 * abs(jl) and abs(ta - ja) <= 1e-6, losses
    H.check_stores(ref, got, 1)

    payloads = {}
    real = AxisCtx.psum_model

    def record(self, xs):
        xs = list(xs)
        if len(xs) > 1:
            payloads.setdefault(self.moe_combine_first, []).append(
                tuple(xs[0].shape))
        return real(self, xs)

    batch = to_device_batch(H.batches(rt.cfg, 1)[0], "cpu")
    out = {}
    AxisCtx.psum_model = record
    try:
        for first in (False, True):
            _, rt2 = H.runtimes("deepseek-v2-lite-16b", 1, 2,
                           cfg_kw=dict(moe_impl="ep"),
                           moe_combine_first=first)
            ps, _ = driver.init_state(rt2, 0)
            loss, aux, _ = rt2.grads(ps, batch)
            out[first] = float(loss + aux)
    finally:
        AxisCtx.psum_model = real
    assert abs(out[True] - out[False]) < 5e-5 * max(abs(out[False]), 1.0)
    e, d = rt.cfg.n_experts, rt.cfg.d_model
    assert any(s[-3] == e and s[-1] == d and len(s) == 4
               for s in payloads[False])
    assert not any(len(s) == 4 and s[-3] == e for s in payloads[True])


def test_train_cli_dp2_tp2(capsys):
    """``launch/train.py --dp 2 --tp 2`` (the reference's example
    defaults, ``examples/train_gpt_hetero.py``) at smoke size on the CPU
    runs and prints its loss."""
    from repro_torch.launch import train

    train.main(["--arch", "qwen3-0.6b", "--smoke", "--dp", "2", "--tp", "2",
                "--steps", "2", "--batch", "4", "--seq", "32",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'model': 2" in out and "'data': 2" in out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
