"""The transfer timeline through the port's rank-parallel trainer
(``timeline_factory=``: one timeline a rank, the gather prefetcher on
rank 0's), against the reference's (``tests/test_timeline.py``'s
distributed case), on the same weights and batch, on the CPU: every
rank's ``StepTimeline`` identical every step, with bandwidth-aware
prefetch on and off, gather stall at a finite collective bandwidth, and
the losses and collective ledger of the run without a timeline."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core.timeline import TransferTimeline as RefTimeline  # noqa: E402
from repro.models.layers import AxisCtx  # noqa: E402
from _torch_parity import reference_hardware, timeline_fields  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.timeline import TransferTimeline  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402

HW = reference_hardware()
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _configs():
    return (jax_config("gpt2-paper-1b", smoke=True).replace(num_layers=2,
                                                            **FP32),
            get_config("gpt2-paper-1b", smoke=True).replace(num_layers=2,
                                                            **FP32))


@pytest.mark.parametrize("aware", [True, False], ids=["aware", "fixed"])
def test_distributed_gather_stall_matches_reference(aware):
    """Each rank's timeline (``timeline_factory=``) and the gather
    prefetcher on rank 0's: identical per-rank StepTimelines, gather
    stall at finite collective bandwidth, and the losses of the run
    without a timeline."""
    from repro.core.distributed import (
        DistributedPatrickStarEngine as RefDist,
    )
    from repro_torch.core.distributed import DistributedPatrickStarEngine

    jcfg, cfg = _configs()
    batch = {k: np.asarray(v) for k, v in make_batch_fn(cfg, 4, 32)().items()
             if k != "mask"}
    kw = dict(nproc=2, device_memory_bytes=4_000_000,
              device_aware_placement=False, bandwidth_aware_prefetch=aware)
    ref = RefDist(jax_model_class(jcfg), jcfg, timeline_factory=lambda:
                  RefTimeline(collective_bandwidth=1e9), **kw)
    port = DistributedPatrickStarEngine(
        model_class(cfg), cfg, device="cpu",
        init_params=params_from_jax(jax_model_class(jcfg)(
            jcfg, AxisCtx()).init_params(jax.random.key(0))),
        timeline_factory=lambda: TransferTimeline(
            collective_bandwidth=1e9, hardware=HW), **kw)
    base = DistributedPatrickStarEngine(
        model_class(cfg), cfg, device="cpu",
        init_params=params_from_jax(jax_model_class(jcfg)(
            jcfg, AxisCtx()).init_params(jax.random.key(0))), **kw)
    for step in range(3):
        a, b, c = ref.step(batch), port.step(batch), base.step(batch)
        assert abs(a.loss - b.loss) <= 1e-5 and abs(b.loss - c.loss) <= 1e-6
        for r, (ra, rb) in enumerate(zip(a.rank_metrics, b.rank_metrics)):
            assert timeline_fields(rb.timeline) == \
                timeline_fields(ra.timeline), (step, r)
            t = rb.timeline
            assert t.gather_stall_s > 0.0
            assert abs(t.wall_s - t.step_s) <= 1e-9 * max(t.wall_s, 1e-30)
        assert b.allgather_bytes == c.allgather_bytes == a.allgather_bytes
    port.check_invariants()
