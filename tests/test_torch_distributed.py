"""The port's rank-parallel eager plane (``repro_torch.core.distributed``)
against the reference ``repro.core.distributed.DistributedPatrickStarEngine``
on the CPU: chunk ownership, the RELEASED remote lifecycle, the
chunk-group all-gather and reduce-scatter, the gather prefetcher and the
stem all-reduce.

Both packages start from the reference model's ``init_params(
jax.random.key(seed))`` (the reference draws them itself; the port gets
them through ``params_from_jax``) and take the same numpy batches.  Per
step: the global loss within 1e-5 relative of the reference's (fp32, the
same math summed in another order), every per-rank ``EngineMetrics``
counter identical, and every per-rank pool ledger identical — all-gather
(hidden and critical), reduce-scatter and all-reduce bytes, h2d/d2h,
prefetch hits and misses, evictions.  Twins of
``tests/test_distributed_engine.py`` and of the eager-parity assertions in
``benchmarks/comm_volume.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core import zero  # noqa: E402
from repro.core.distributed import (  # noqa: E402
    DistributedPatrickStarEngine as RefDist,
)
from repro.models.layers import AxisCtx  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistributedPatrickStarEngine,
)
from repro_torch.core.engine import PatrickStarEngine  # noqa: E402
from repro_torch.core.state import (  # noqa: E402
    ChunkState,
    IllegalTransition,
    TensorState,
    check_transition,
    derive_chunk_state,
)

LOSS_TOL = 1e-5  # relative, against the reference
SINGLE_RANK_TOL = 1e-4  # absolute, p ranks against one (the reference's)
COUNTERS = ("h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes", "prefetch_hits",
            "demand_misses", "peak_device_bytes")
STEP_COLLECTIVES = ("allgather_bytes", "reduce_scatter_bytes",
                    "allreduce_bytes", "hidden_allgather_bytes",
                    "critical_allgather_bytes")
P2 = dict(nproc=2, device_memory_bytes=4_000_000, lr=1e-2)


def _configs(**over):
    kw = dict(param_dtype="float32", compute_dtype="float32", **over)
    return (jax_config("gpt2-paper-1b", smoke=True).replace(**kw),
            get_config("gpt2-paper-1b", smoke=True).replace(**kw))


def _batch(cfg, b=4, s=32, seed=1):
    """``tests/test_distributed_engine.py``'s batch, as numpy arrays."""
    tok = np.asarray(jax.random.randint(jax.random.key(seed), (b, s), 0,
                                        cfg.vocab_size))
    return {"tokens": tok, "labels": np.roll(tok, -1, 1),
            "global_tokens": np.float32(b * s)}


def _port_params(jcfg, seed=0):
    """The reference's own init, as the port's param tree."""
    params = jax_model_class(jcfg)(jcfg, AxisCtx()).init_params(
        jax.random.key(seed))
    return params_from_jax(jax.tree.map(np.asarray, params))


def _engines(cfg_over=None, **kw):
    jcfg, cfg = _configs(**(cfg_over or {}))
    ref = RefDist(jax_model_class(jcfg), jcfg, **kw)
    port = DistributedPatrickStarEngine(
        model_class(cfg), cfg, device="cpu",
        init_params=_port_params(jcfg, kw.get("seed", 0)), **kw)
    return ref, port


def _pool_ledgers(dist):
    """Each rank's cumulative pool ledgers."""
    return [dict(collectives=dataclasses.asdict(c.pool.collectives),
                 transfers=dataclasses.asdict(c.pool.stats),
                 prefetch=dataclasses.asdict(c.pool.prefetch),
                 evictions=dict(c.pool.evictions),
                 peak_device_bytes=c.pool.peak_device_bytes)
            for c in dist.ranks]


def _record(m):
    return (m.loss, {f: getattr(m, f) for f in STEP_COLLECTIVES},
            [{f: getattr(rm, f) for f in COUNTERS} for rm in m.rank_metrics])


def _run_pair(ref, port, batches):
    """Step both engines in turn; assert the per-step parity and return
    the port's step metrics."""
    out = []
    for step, batch in enumerate(batches):
        lw, cw, rw = _record(ref.step(batch))
        m = port.step(batch)
        lg, cg, rg = _record(m)
        assert np.isfinite(lg)
        assert abs(lg - lw) <= LOSS_TOL * abs(lw), (step, lg, lw)
        assert cg == cw, (step, cg, cw)
        assert rg == rw, (step, rg, rw)
        assert _pool_ledgers(port) == _pool_ledgers(ref), step
        out.append(m)
    assert [(p.name, p.chunk_id, p.offset) for p in port.cmap.placements] \
        == [(p.name, p.chunk_id, p.offset) for p in ref.cmap.placements]
    port.check_invariants()
    return out


def _exact_chunked_volume(dist):
    """3(p-1)/p of the chunk-store capacity, as exact integer bytes."""
    g = dist.cmap.num_comm_groups
    cb = dist.ranks[0].params_mgr.chunk_bytes
    return 3 * (dist.nproc - 1) * g * cb


@pytest.fixture(scope="module")
def p2_run():
    ref, port = _engines(**P2)
    batch = _batch(port.ranks[0].cfg)
    return ref, port, batch, _run_pair(ref, port, [batch] * 4)


# ---------------------------------------------------------------------------
# p ranks against the reference, against one rank, and the analytic volume
# ---------------------------------------------------------------------------


def test_p2_matches_reference_single_rank_and_analytic_volume(p2_run):
    ref, port, batch, mets = p2_run
    exact = _exact_chunked_volume(port)
    vol = zero.comm_volume_bytes(port.cmap, itemsize=4)
    assert exact == int(vol["chunked_capacity_bytes"])
    assert vol["chunked_allgather_bytes"] <= vol["chunked_capacity_bytes"]
    jcfg, cfg = _configs()
    single = PatrickStarEngine(
        model_class(cfg), cfg, device="cpu", device_memory_bytes=4_000_000,
        lr=1e-2, init_params=_port_params(jcfg))
    for step, md in enumerate(mets):
        ms = single.step(batch)
        # same math (grads reduce-scatter-summed, shard losses carry
        # 1/global_tokens); only float association differs
        assert abs(ms.loss - md.loss) < SINGLE_RANK_TOL, (step, ms.loss,
                                                          md.loss)
        # measured all-gather + reduce-scatter == the analytic chunked
        # volume, exactly, every step (warm-up included)
        assert md.chunk_collective_bytes == exact, step
        assert md.allgather_bytes == 2 * md.reduce_scatter_bytes
        assert (md.hidden_allgather_bytes + md.critical_allgather_bytes
                == md.allgather_bytes)
    assert md.loss < 0.7 * 6.8  # and it learns
    # the config pages: every rank moved bytes over its own h2d plane
    assert all(sum(m.rank_metrics[r].h2d_bytes for m in mets) > 0
               for r in range(port.nproc))


def test_p4_under_eviction_pressure_matches_reference():
    # per-rank budget far below the model: remote fetch and cross-stream
    # eviction must cooperate
    ref, port = _engines(cfg_over=dict(num_layers=4), nproc=4,
                         device_memory_bytes=2_000_000, lr=1e-2)
    exact = _exact_chunked_volume(port)
    mets = _run_pair(ref, port, [_batch(port.ranks[0].cfg)] * 3)
    for md in mets:
        assert md.chunk_collective_bytes == exact
    assert sum(sum(port.ranks[r].pool.evictions.values())
               for r in range(4)) > 0


@pytest.mark.parametrize("p", [2, 4])
def test_comm_volume_eager_parity(p):
    """``benchmarks/comm_volume.py``'s eager-distributed proof: the
    measured volume equals the analytic 3(p-1)/p chunk-store volume on
    the warm-up and the steady step, and the gather prefetcher turns
    critical bytes hidden at equal volume."""
    ref, port = _engines(nproc=p, device_memory_bytes=4_000_000, lr=1e-2)
    from repro_torch.data.pipeline import make_batch_fn

    nxt = make_batch_fn(port.ranks[0].cfg, 4, 32)
    warm, post = _run_pair(ref, port, [nxt() for _ in range(2)])
    exact = int(zero.comm_volume_bytes(port.cmap,
                                       itemsize=4)["chunked_capacity_bytes"])
    for m in (warm, post):
        assert m.chunk_collective_bytes == exact, (p, m.chunk_collective_bytes)
        assert m.allgather_bytes == 2 * m.reduce_scatter_bytes
    assert warm.hidden_allgather_bytes == 0
    assert post.hidden_allgather_bytes > 0
    assert (post.hidden_allgather_bytes + post.critical_allgather_bytes
            == post.allgather_bytes)


@pytest.mark.parametrize("look", [0, 2])
def test_gather_prefetch_hides_collective_bytes(look):
    """Post-warm-up the gather prefetcher converts critical-path
    all-gather bytes into hidden ones without changing the volume; with
    lookahead 0 every gather is on demand — both as the reference."""
    ref, port = _engines(gather_lookahead=look, **P2)
    batch = _batch(port.ranks[0].cfg)
    _, steady = _run_pair(ref, port, [batch] * 2)
    assert steady.allgather_bytes > 0
    if look == 0:
        assert port.gather_prefetcher is None
        assert steady.hidden_allgather_bytes == 0
        assert steady.critical_allgather_bytes == steady.allgather_bytes
    else:
        assert steady.hidden_allgather_bytes > 0
        assert port.gather_prefetcher.installed
        # every staged group was retired once its replicas dropped
        assert port.gather_prefetcher.inflight == frozenset()


def test_stem_allreduce_counted_separately(p2_run):
    _, port, _, mets = p2_run
    stem = sum(t.numel() for t in port.ranks[0]._stem)
    for m in mets:
        # ring all-reduce of the fp32 stem grads: 2 (p-1)/p of its bytes
        assert m.allreduce_bytes == 2 * (2 - 1) * stem * 4 // 2 > 0
        # the chunked-plane parity quantity excludes it
        assert m.chunk_collective_bytes == _exact_chunked_volume(port)
    # the stem is replicated: every rank reads rank 0's updated tensors
    assert all(core._stem is port.ranks[0]._stem for core in port.ranks)


# ---------------------------------------------------------------------------
# remote lifecycle mechanics
# ---------------------------------------------------------------------------


def test_remote_lifecycle_and_ownership():
    jcfg, cfg = _configs()
    dist = DistributedPatrickStarEngine(
        model_class(cfg), cfg, device="cpu", init_params=_port_params(jcfg),
        **P2)
    cmap = dist.cmap

    # at init and between steps: every non-owned payload chunk is RELEASED
    # (no local payload), every owned chunk has an authoritative payload
    def assert_shard_invariant():
        for r, core in enumerate(dist.ranks):
            for c in range(cmap.num_chunks):
                if not cmap.chunk_tensors(c):
                    continue
                if cmap.chunk_owner(c) == r:
                    assert core.params_mgr._records[c].payload is not None
                    assert core.params_mgr.chunk_state(c) \
                        is not ChunkState.RELEASED
                else:
                    assert core.params_mgr.chunk_state(c) \
                        is ChunkState.RELEASED
                    assert core.params_mgr._records[c].payload is None

    assert_shard_invariant()
    dist.step(_batch(cfg))
    assert_shard_invariant()  # post-RS the replicas are dropped again

    # OS streams exist only for owned chunks (ADAM is local, Section 7)
    for r, core in enumerate(dist.ranks):
        for c in range(cmap.num_chunks):
            if not cmap.chunk_tensors(c) or cmap.chunk_owner(c) == r:
                continue
            for m in core.os_mgrs.values():
                assert m._records[c].payload is None

    # accessing a RELEASED tensor without the collective is an error, not
    # a silent zero-fill
    core = dist.ranks[0]
    remote = next(p.name for p in cmap.placements
                  if cmap.chunk_owner(p.chunk_id) != 0)
    with pytest.raises(RuntimeError, match="RELEASED"):
        core.params_mgr.access_tensor(remote)

    # the landing pad: RELEASED -> HOLD, pool admission, no tier bytes
    c = cmap.placement(remote).chunk_id
    h2d = core.pool.stats.h2d_bytes
    pad = core.params_mgr.materialize_chunk(c, "device")
    assert pad.numel() == cmap.chunk_size
    assert core.params_mgr.chunk_state(c) is ChunkState.HOLD
    assert core.pool.stats.h2d_bytes == h2d
    core.params_mgr.mark_released(c)
    assert core.params_mgr._records[c].payload is None
    assert core.params_mgr.chunk_state(c) is ChunkState.RELEASED
    assert not core.params_mgr.comm_group_state_complete(
        cmap.comm_group(c), TensorState.HOLD)


def test_telemetry_events_match_reference():
    """One hub for every rank: the same rank-tagged events (tier moves,
    state changes, the collectives) as the reference's."""
    from repro.core.telemetry import Telemetry as RefHub
    from repro_torch.core.telemetry import Telemetry

    jcfg, cfg = _configs()
    ref_hub, hub = RefHub(), Telemetry()
    ref = RefDist(jax_model_class(jcfg), jcfg, telemetry=ref_hub, **P2)
    port = DistributedPatrickStarEngine(
        model_class(cfg), cfg, device="cpu", telemetry=hub,
        init_params=_port_params(jcfg), **P2)
    _run_pair(ref, port, [_batch(port.ranks[0].cfg)] * 2)

    def events(h):
        return [(e.kind, e.name, e.stream, e.chunk_id, e.nbytes, e.rank)
                for e in h.events]

    assert events(hub) == events(ref_hub)
    assert hub.collective_bytes() == ref_hub.collective_bytes()
    assert any(e.kind == "collective" for e in hub.events)


# ---------------------------------------------------------------------------
# state machine: RELEASED
# ---------------------------------------------------------------------------


def test_released_state_machine():
    assert derive_chunk_state([TensorState.RELEASED]) is ChunkState.RELEASED
    assert derive_chunk_state(
        [TensorState.RELEASED, TensorState.HOLD]) is ChunkState.HOLD
    assert derive_chunk_state(
        [TensorState.RELEASED, TensorState.COMPUTE]) is ChunkState.COMPUTE
    assert derive_chunk_state([TensorState.FREE]) is ChunkState.FREE

    check_transition(TensorState.HOLD_AFTER_FWD, TensorState.RELEASED)
    check_transition(TensorState.HOLD_AFTER_BWD, TensorState.RELEASED)
    check_transition(TensorState.RELEASED, TensorState.HOLD)
    check_transition(TensorState.RELEASED, TensorState.COMPUTE)
    with pytest.raises(IllegalTransition):
        check_transition(TensorState.RELEASED, TensorState.FREE)
    with pytest.raises(IllegalTransition):
        check_transition(TensorState.COMPUTE, TensorState.RELEASED)


# ---------------------------------------------------------------------------
# what the port does not take, and its default device
# ---------------------------------------------------------------------------


def test_unported_and_invalid_options_raise():
    _, cfg = _configs()
    with pytest.raises(ValueError, match="nproc"):
        DistributedPatrickStarEngine(model_class(cfg), cfg, device="cpu",
                                     **dict(P2, nproc=1))
    with pytest.raises(ValueError, match="collective"):
        PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                          device_memory_bytes=1 << 30, nproc=2)


def test_entry_point_runs_on_cuda_or_raises():
    _, cfg = _configs()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        DistributedPatrickStarEngine(model_class(cfg), cfg, **P2)
