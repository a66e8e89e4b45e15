"""The port's rank-sharded serving fleet (``repro_torch.core.distributed.
DistributedServingEngine``) against the reference fleet on the same
weights (the reference's ``init_params(jax.random.key(seed))``, brought
over with ``params_from_jax``), on the CPU: round-robin placement,
lock-step rounds, the same greedy tokens and per-round counters as the
reference fleet and as one ``ServingEngine``, and zero collective bytes.
Twins of ``tests/test_distributed_serving.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core.distributed import (  # noqa: E402
    DistributedServingEngine as RefFleet,
)
from repro.models.layers import AxisCtx  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistributedServingEngine,
)
from repro_torch.core.serving import ServingEngine  # noqa: E402

KW = dict(device_memory_bytes=1_300_000, host_memory_bytes=8_000_000,
          max_seq_len=40, page_tokens=8)
ROUND_COUNTERS = ("admitted", "completed", "active", "queued",
                  "prefill_tokens", "decode_tokens", "peak_device_bytes")
RANK_COUNTERS = ("h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
                 "critical_h2d_bytes", "prefetch_hits", "demand_misses",
                 "peak_device_bytes")


def _configs():
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (jax_config("qwen3-0.6b", smoke=True).replace(**kw),
            get_config("qwen3-0.6b", smoke=True).replace(**kw))


def _prompts(cfg, n, plen, seed=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
            for _ in range(n)]


def _rank_rows(m):
    return [None if r is None else {f: getattr(r, f) for f in RANK_COUNTERS}
            for r in m.rank_metrics]


def test_fleet_matches_reference_and_single_engine():
    """A 2-rank paged fleet serves a burst to the reference fleet's
    tokens, round by round and rank by rank, and to one engine's tokens;
    it places sequences round-robin, books ZERO collective bytes on every
    rank and sums per-rank capacity."""
    jcfg, cfg = _configs()
    params = params_from_jax(jax.tree.map(
        np.asarray,
        jax_model_class(jcfg)(jcfg, AxisCtx()).init_params(
            jax.random.key(0))))
    prompts = _prompts(cfg, 6, 8)
    news = [8, 4, 8, 6, 8, 5]

    oracle_eng = ServingEngine(model_class(cfg), cfg, device="cpu",
                               init_params=params, **KW)
    rids = [oracle_eng.submit(p, n) for p, n in zip(prompts, news)]
    oracle_eng.run()
    oracle = [oracle_eng.result(r) for r in rids]

    ref = RefFleet(jax_model_class(jcfg), jcfg, nproc=2, **KW)
    fleet = DistributedServingEngine(model_class(cfg), cfg, nproc=2,
                                     device="cpu", init_params=params, **KW)
    ref_gids = [ref.submit(p, n) for p, n in zip(prompts, news)]
    gids = [fleet.submit(p, n) for p, n in zip(prompts, news)]
    assert gids == ref_gids
    # round-robin placement: alternating ranks, in submit order
    assert [fleet._placement[g][0] for g in gids] == [0, 1, 0, 1, 0, 1]
    ref_mets = ref.run()
    mets = fleet.run()
    fleet.check_invariants()  # includes the zero-collectives assertion

    assert [fleet.result(g) for g in gids] == [ref.result(g) for g in gids]
    assert [fleet.result(g) for g in gids] == oracle
    assert len(mets) == len(ref_mets)
    for a, b in zip(ref_mets, mets):
        assert {f: getattr(b, f) for f in ROUND_COUNTERS} == \
            {f: getattr(a, f) for f in ROUND_COUNTERS}, a.round_index
        assert _rank_rows(b) == _rank_rows(a), a.round_index
    assert fleet.total_decode_tokens == oracle_eng.total_decode_tokens
    assert fleet.total_prefill_tokens == oracle_eng.total_prefill_tokens
    assert fleet.peak_concurrency == ref.peak_concurrency == sum(
        c.peak_concurrency for c in fleet.ranks)
    assert sum(m.completed for m in mets) == len(prompts)
    assert all(m.peak_device_bytes <= KW["device_memory_bytes"]
               for m in mets)
    assert all(c.pool.collectives.total_bytes == 0 for c in fleet.ranks)
    assert fleet.active_count == 0 and fleet.queued_count == 0
    assert fleet.step_round() is None  # drained


def test_fleet_as_tenants_of_shared_pools_matches_reference():
    """``pools=``/``tenants=``: each rank a budgeted, prioritised tenant
    of its own shared pool (one pool per simulated device).  The same
    tokens and per-rank counters as the reference fleet on such pools,
    each rank's budget held every round, zero collective bytes."""
    from repro.core.memory import HeteroMemory as RefPool
    from repro_torch.core.memory import HeteroMemory

    jcfg, cfg = _configs()
    params = jax_model_class(jcfg)(jcfg, AxisCtx()).init_params(
        jax.random.key(0))
    prompts = _prompts(cfg, 4, 8)
    budget = KW["device_memory_bytes"]
    fleets = []
    for pool_cls, extra in ((RefPool, {}), (HeteroMemory, {"device": "cpu"})):
        pools = [pool_cls(device_capacity_bytes=2 * budget,
                          host_capacity_bytes=16_000_000, policy="opt",
                          **extra) for _ in range(2)]
        tenants = [p.create_tenant("serve", priority=10,
                                   device_budget_bytes=budget)
                   for p in pools]
        fleets.append((pools, tenants))
    kw = {k: v for k, v in KW.items() if k != "host_memory_bytes"}
    ref = RefFleet(jax_model_class(jcfg), jcfg, nproc=2, pools=fleets[0][0],
                   tenants=fleets[0][1], **kw)
    fleet = DistributedServingEngine(
        model_class(cfg), cfg, nproc=2, device="cpu",
        init_params=params_from_jax(jax.tree.map(np.asarray, params)),
        pools=fleets[1][0], tenants=fleets[1][1], **kw)
    assert all(c.tenant is t for c, t in zip(fleet.ranks, fleets[1][1]))
    gids = [fleet.submit(p, 6) for p in prompts]
    assert gids == [ref.submit(p, 6) for p in prompts]
    ref_mets, mets = ref.run(), fleet.run()
    fleet.check_invariants()
    assert [fleet.result(g) for g in gids] == [ref.result(g) for g in gids]
    assert len(mets) == len(ref_mets)
    for a, b in zip(ref_mets, mets):
        assert _rank_rows(b) == _rank_rows(a), a.round_index
        assert all(r is None or r.peak_device_bytes <= budget
                   for r in b.rank_metrics)


@pytest.mark.parametrize("case,exc,match", [
    (dict(nproc=0), ValueError, "nproc"),
    (dict(pools=[None]), ValueError, "one entry per rank"),
], ids=["nproc", "pools-length"])
def test_fleet_validates_and_refuses_unported_options(case, exc, match):
    _, cfg = _configs()
    kw = dict(dict(nproc=2, device="cpu", device_memory_bytes=1_300_000,
                   host_memory_bytes=8_000_000, max_seq_len=24), **case)
    with pytest.raises(exc, match=match):
        DistributedServingEngine(model_class(cfg), cfg, **kw)


def test_fleet_entry_point_runs_on_cuda_or_raises():
    _, cfg = _configs()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        DistributedServingEngine(model_class(cfg), cfg, nproc=2,
                                 device_memory_bytes=1_300_000)
