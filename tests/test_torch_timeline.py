"""The transfer timeline through the port's trainer, against the
reference's (``tests/test_timeline.py``'s engine cases; its rank-parallel
cases are in ``test_torch_timeline_distributed.py``, its serving cases in
``test_torch_serving_options.py``), on the same weights and batches, on
the CPU.

Both packages price operators with the same constants: the port's
timeline carries a ``Hardware`` built from the reference's roofline
module, so every ``StepTimeline`` field of every step and round —
compute, each lane's stall, the wall, the per-stream and per-moment
stall maps — must be *identical* (the simulated clock sees only bytes,
moments and durations), with bandwidth-aware prefetch on and off; and so
must every counter.  Losses agree to 1e-5, tokens exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core.engine import PatrickStarEngine as RefEngine  # noqa: E402
from repro.core.timeline import TransferTimeline as RefTimeline  # noqa: E402
from repro.models.layers import AxisCtx  # noqa: E402
from _torch_parity import (  # noqa: E402
    numpy_params,
    reference_hardware,
    timeline_fields,
)
from repro_torch.analysis.costmodel import train_operator_costs  # noqa: E402
from repro_torch.analysis.roofline import H100_SXM  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.engine import PatrickStarEngine  # noqa: E402
from repro_torch.core.timeline import TransferTimeline  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402

HW = reference_hardware()
COUNTERS = ("h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes", "prefetch_hits",
            "demand_misses", "peak_device_bytes")
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _configs(arch="gpt2-paper-1b", layers=4):
    return (jax_config(arch, smoke=True).replace(num_layers=layers, **FP32),
            get_config(arch, smoke=True).replace(num_layers=layers, **FP32))


def _batches(cfg, n, b, s):
    nxt = make_batch_fn(cfg, b, s)
    return [{k: v for k, v in nxt().items() if k != "mask"}
            for _ in range(n)]


def _lanes(**bw):
    """The same lanes in both packages; the port's priced on the
    reference's constants."""
    return RefTimeline(**bw), TransferTimeline(hardware=HW, **bw)


def _train_pair(jcfg, cfg, timelines, **kw):
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    ref = RefEngine(jax_model_class(jcfg), jcfg, init_params=params,
                    timeline=timelines[0], **kw)
    port = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                             init_params=params_from_jax(params),
                             timeline=timelines[1], **kw)
    return ref, port


def _assert_steps_equal(ref, port, batches):
    out = []
    for i, batch in enumerate(batches):
        a, b = ref.step(batch), port.step(batch)
        assert abs(a.loss - b.loss) <= 1e-5, (i, a.loss, b.loss)
        assert {f: getattr(b, f) for f in COUNTERS} == \
            {f: getattr(a, f) for f in COUNTERS}, i
        assert timeline_fields(b.timeline) == timeline_fields(a.timeline), i
        t = b.timeline
        assert abs(t.wall_s - t.step_s) <= 1e-9 * max(t.wall_s, 1e-30)
        out.append(b)
    port.pool.check_invariants()
    return out


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aware", [True, False], ids=["aware", "fixed"])
def test_engine_finite_bandwidth_matches_reference(aware):
    jcfg, cfg = _configs()
    ref, port = _train_pair(
        jcfg, cfg, _lanes(h2d_bandwidth=1e8, d2h_bandwidth=1e8),
        device_memory_bytes=4_000_000, device_aware_placement=True,
        bandwidth_aware_prefetch=aware)
    mets = _assert_steps_equal(ref, port, _batches(cfg, 3, 4, 64))
    assert all(m.timeline.stall_s > 0.0 for m in mets)
    assert any(v > 0 for v in mets[-1].timeline.stall_by_stream.values())


def test_engine_infinite_bandwidth_zero_stall():
    jcfg, cfg = _configs()
    ref, port = _train_pair(jcfg, cfg, _lanes(),
                            device_memory_bytes=4_000_000,
                            device_aware_placement=False)
    mets = _assert_steps_equal(ref, port, _batches(cfg, 3, 4, 64))
    for t in (m.timeline for m in mets[1:]):
        assert t.stall_s == 0.0 and t.compute_s > 0.0
        # the wall is the clock's own sum: equal up to float association
        assert t.step_s == t.compute_s
        assert abs(t.wall_s - t.compute_s) <= 1e-12 * t.compute_s


def test_bandwidth_aware_prefetch_cuts_stall_at_equal_volume():
    """The reference's acceptance bar in miniature, on both packages: the
    same bytes, the same losses, less stall, identical timelines.  (The
    reference's losses are bit-equal on and off; the port's CPU GEMMs may
    split their sums by the threads free at the time, so its two runs
    agree to 1e-6 relative; the card's phase holds them exactly.)"""
    jcfg, cfg = _configs()
    batches = _batches(cfg, 3, 4, 64)

    def run(aware):
        ref, port = _train_pair(
            jcfg, cfg, _lanes(), device_memory_bytes=4_000_000,
            device_aware_placement=True, bandwidth_aware_prefetch=aware)
        cb = port.params_mgr.chunk_bytes
        costs = train_operator_costs(cfg, hw=HW, global_batch=4, seq_len=64,
                                     num_layer_ops=4, chunk_bytes=cb)
        bw = cb / costs.fwd_layer_s  # one chunk's wire = one fwd layer
        for tl in (ref.timeline, port.timeline):
            tl.h2d.bandwidth = tl.d2h.bandwidth = bw
        mets = _assert_steps_equal(ref, port, batches)[1:]
        return dict(h2d=sum(m.h2d_bytes + m.adam_h2d_bytes for m in mets),
                    d2h=sum(m.d2h_bytes + m.adam_d2h_bytes for m in mets),
                    stall=sum(m.timeline.stall_s for m in mets),
                    loss=[m.loss for m in mets])

    fixed, aware = run(False), run(True)
    assert (aware["h2d"], aware["d2h"]) == (fixed["h2d"], fixed["d2h"])
    np.testing.assert_allclose(aware["loss"], fixed["loss"], rtol=1e-6)
    assert aware["stall"] < fixed["stall"], (aware["stall"], fixed["stall"])


def test_aware_prefetch_is_not_volume_neutral_at_a_deep_budget():
    """Six layers under a third of the model data: the bandwidth-aware
    prefetcher stages chunks the fixed depth would evict and fetch again,
    so after the warm-up it moves FEWER bytes each way — in the reference
    as in the port, step for step (the reference's equal-volume bar holds
    on its own scenario above, not in general)."""
    jcfg, cfg = _configs(layers=6)
    batches = _batches(cfg, 3, 4, 64)

    def run(aware):
        ref, port = _train_pair(
            jcfg, cfg, _lanes(), device_memory_bytes=7_018_905,
            device_aware_placement=True, bandwidth_aware_prefetch=aware)
        cb = port.params_mgr.chunk_bytes
        costs = train_operator_costs(cfg, hw=HW, global_batch=4, seq_len=64,
                                     num_layer_ops=6, chunk_bytes=cb)
        for tl in (ref.timeline, port.timeline):
            tl.h2d.bandwidth = tl.d2h.bandwidth = cb / costs.fwd_layer_s
        mets = _assert_steps_equal(ref, port, batches)
        return ([m.h2d_bytes + m.adam_h2d_bytes for m in mets],
                [m.d2h_bytes + m.adam_d2h_bytes for m in mets])

    (ah, ad), (fh, fd) = run(True), run(False)
    assert ah[0] == fh[0] and ad[0] == fd[0]  # the warm-up
    assert sum(ah) < sum(fh) and sum(ad) < sum(fd)


def test_batch_shape_change_reinstalls_durations():
    """A new batch shape re-arms the warm-up: the durations are cleared
    and, after the re-warm-up, installed for the new shape — the next
    step's compute is a fresh engine's on that shape."""
    _, cfg = _configs()
    kw = dict(device="cpu", device_memory_bytes=4_000_000,
              device_aware_placement=False)
    eng = PatrickStarEngine(model_class(cfg), cfg, timeline=TransferTimeline(
        h2d_bandwidth=1e8, d2h_bandwidth=1e8, hardware=HW), **kw)
    fresh = PatrickStarEngine(model_class(cfg), cfg, timeline=TransferTimeline(
        h2d_bandwidth=1e8, d2h_bandwidth=1e8, hardware=HW), **kw)
    small, large = _batches(cfg, 2, 2, 32), _batches(cfg, 2, 4, 64)
    for batch in small:
        eng.step(batch)
    eng.step(large[0])  # the re-warm-up step
    assert eng._batch_tokens_shape == (4, 64)
    want = [fresh.step(b).timeline.compute_s for b in large]
    assert eng.step(large[1]).timeline.compute_s == want[1] > 0.0


def test_engine_without_timeline_reports_none():
    _, cfg = _configs(layers=2)
    eng = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                            device_memory_bytes=4_000_000)
    assert eng.step(_batches(cfg, 1, 2, 16)[0]).timeline is None


# ---------------------------------------------------------------------------
# the calibrated timeline
# ---------------------------------------------------------------------------


def test_calibrated_lanes():
    """``calibrated(hw)`` puts every lane at ``hw``'s rates (the
    reference's ``calibrated()`` under its own constants) and carries
    ``hw``; with no measured rates it is the recorded H100 — never an
    infinite h2d/d2h lane."""
    mine, ref = TransferTimeline.calibrated(HW), RefTimeline.calibrated()
    for lane in ("h2d", "d2h", "h2s", "s2h", "coll"):
        assert getattr(mine, lane).bandwidth == getattr(ref, lane).bandwidth
    assert mine.hardware is HW
    h100 = TransferTimeline.calibrated()
    assert h100.hardware is H100_SXM
    assert (h100.h2d.bandwidth, h100.d2h.bandwidth,
            h100.coll.bandwidth) == (H100_SXM.h2d_bw, H100_SXM.d2h_bw,
                                     H100_SXM.collective_bw)
    assert h100.h2s.bandwidth is None  # the slow tier is CPU memory
    measured = dataclasses.replace(H100_SXM, h2d_bw=50.5e9)
    assert TransferTimeline.calibrated(measured).h2d.bandwidth == 50.5e9
    # a plain timeline prices the card it runs on
    assert TransferTimeline().hardware is H100_SXM
