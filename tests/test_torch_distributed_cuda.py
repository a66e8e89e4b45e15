"""The port's rank-parallel trainer on the card against itself on the CPU
(same weights, same batches, two ranks simulated on one card): per-step
losses within 1e-4 relative, every per-rank counter and pool ledger
identical, and K2 and K1 launched exactly as often as the plan implies.
Needs a card; skips without one."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistributedPatrickStarEngine,
)
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.kernels import chunked_adam as ka  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.layers import AxisCtx  # noqa: E402

COUNTERS = ("h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes", "prefetch_hits",
            "demand_misses", "peak_device_bytes")


def _train(cfg, params, batches, device):
    dist = DistributedPatrickStarEngine(
        model_class(cfg), cfg, nproc=2, device=device,
        device_memory_bytes=4_000_000, lr=1e-2, init_params=params)
    mets = [dist.step(b) for b in batches]
    dist.check_invariants()
    ledgers = [dict(collectives=dataclasses.asdict(c.pool.collectives),
                    transfers=dataclasses.asdict(c.pool.stats),
                    evictions=dict(c.pool.evictions)) for c in dist.ranks]
    return dist, mets, ledgers


@pytest.mark.gpu
def test_card_p2_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gpt2-paper-1b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    params = model_class(cfg)(cfg, AxisCtx()).init_params(
        torch.Generator().manual_seed(0))
    nxt = make_batch_fn(cfg, 4, 32)
    batches = [nxt() for _ in range(3)]
    _, cpu_mets, cpu_ledgers = _train(cfg, params, batches, "cpu")
    fa.launches = fa.bwd_launches = ka.launches = 0
    dist, gpu_mets, gpu_ledgers = _train(cfg, params, batches, "cuda")
    launches = (fa.launches, fa.bwd_launches, ka.launches)
    for a, b in zip(cpu_mets, gpu_mets):
        assert np.isfinite(b.loss)
        assert abs(a.loss - b.loss) <= 1e-4 * abs(a.loss), (a.loss, b.loss)
        assert b.chunk_collective_bytes == a.chunk_collective_bytes > 0
        assert b.hidden_allgather_bytes == a.hidden_allgather_bytes
        assert [{f: getattr(m, f) for f in COUNTERS}
                for m in b.rank_metrics] == \
            [{f: getattr(m, f) for f in COUNTERS} for m in a.rank_metrics]
    assert gpu_ledgers == cpu_ledgers
    assert gpu_mets[-1].hidden_allgather_bytes > 0
    layers, steps = cfg.num_layers, len(batches)
    owned_dev = sum(
        1 for r, core in enumerate(dist.ranks)
        for c in core.placement.os_device_chunk_ids(core.cmap)
        if core.cmap.chunk_tensors(c) and core.cmap.chunk_owner(c) == r)
    assert launches == (2 * 2 * layers * steps, 2 * layers * steps,
                        owned_dev * (steps - 1))
