"""Co-tenancy: a serving job and a training job on ONE memory pool, or
a serving fleet and a rank-parallel trainer on one pool a rank
(:func:`coresident_fleets`).

The port's counterpart of the reference's co-tenancy benchmark functions
(``benchmarks/cotenancy.py``): a :class:`~repro_torch.core.serving.
ServingEngine` serves one model as a prioritised tenant with per-tier
soft budgets while a :class:`~repro_torch.core.engine.PatrickStarEngine`
trains another as a budget-less tenant that backfills the rest, both
leased from one :class:`~repro_torch.core.memory.HeteroMemory` (on a
CUDA pool: one card, one copy stream, one pinned host tier).  Compared
against each engine alone on a private pool of its share, and against a
static split of the pool into two halves.

These functions check the serve tenant's contract every round — its device
peak within its device budget, its host use within its host budget, and
no serve chunk ever evicted for the trainer (the priority shield) — and
raise ``AssertionError`` on a breach.  Tokens, losses, latencies and
throughputs are returned for the caller's bars: co-resident tokens equal
solo tokens, co-resident losses equal solo losses, and the modelled (the
shared timeline's ``wall_s``) or measured (host clock) latency and
throughput ratios.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable

from repro_torch.configs import model_class
from repro_torch.core.engine import PatrickStarEngine
from repro_torch.core.memory import HeteroMemory, OutOfMemory
from repro_torch.core.serving import ServingEngine
from repro_torch.core.timeline import TransferTimeline


@dataclasses.dataclass(frozen=True)
class Shares:
    """The pool and the two tenants' shares of it, in bytes."""

    serve_device: int  # serve tenant's device soft budget
    serve_host: int  # serve tenant's host soft budget
    train_device: int  # trainer's planning share (not a budget)
    device_pool: int
    host_pool: int | None


SERVE_PRIORITY = 10  # the serve tenant's eviction priority (the trainer's 0)
SERVE_EVERY = 3  # serving rounds between two training steps


@dataclasses.dataclass
class ServeRun:
    tokens: list[list[int]]
    rounds: list  # ServeRoundMetrics
    engine: ServingEngine


@dataclasses.dataclass
class TrainRun:
    losses: list[float]
    steps: list  # EngineMetrics
    engine: PatrickStarEngine


def _check_serve_round(m, tenant, pool, budgets) -> None:
    dev_budget, host_budget = budgets
    if m.peak_device_bytes > dev_budget:
        raise AssertionError(
            f"round {m.round_index}: serve device peak {m.peak_device_bytes}"
            f" > its budget {dev_budget}")
    if tenant.host_bytes_used() > host_budget:
        raise AssertionError(
            f"round {m.round_index}: serve host use "
            f"{tenant.host_bytes_used()} > its budget {host_budget}")
    if pool.evictions[("serve", "train")] != 0:
        raise AssertionError(
            f"round {m.round_index}: the trainer evicted serve chunks "
            f"{dict(pool.evictions)}")


def solo_serving(cfg, params, prompts, new_tokens, *, device_bytes: int,
                 host_bytes: int | None, timeline: TransferTimeline,
                 device, **serve_kw) -> ServeRun:
    """The serving job alone on a private pool of its share."""
    eng = ServingEngine(model_class(cfg), cfg, device=device,
                        device_memory_bytes=device_bytes,
                        host_memory_bytes=host_bytes, timeline=timeline,
                        init_params=params, **serve_kw)
    rids = [eng.submit(p, new_tokens) for p in prompts]
    rounds = []
    while (m := eng.step_round()) is not None:
        rounds.append(m)
        eng.check_invariants()
    eng.pool.check_invariants()
    return ServeRun([eng.result(r) for r in rids], rounds, eng)


def solo_training(cfg, params, batches, *, device_bytes: int,
                  host_bytes: int | None, timeline: TransferTimeline,
                  device, **train_kw) -> TrainRun:
    """The training job alone on a private pool of its share (raises
    :class:`OutOfMemory` where the share cannot hold it)."""
    eng = PatrickStarEngine(model_class(cfg), cfg, device=device,
                            device_memory_bytes=device_bytes,
                            host_memory_bytes=host_bytes, timeline=timeline,
                            init_params=params, **train_kw)
    steps = [eng.step(b) for b in batches]
    eng.pool.check_invariants()
    return TrainRun([float(m.loss) for m in steps], steps, eng)


def coresident(serve_cfg, serve_params, prompts, new_tokens,
               train_cfg, train_params, batches, shares: Shares, *,
               timeline: TransferTimeline, device,
               serve_kw: dict | None = None, train_kw: dict | None = None):
    """Both engines on one pool: the server runs up to ``SERVE_EVERY``
    rounds, then the trainer takes a step, until both are done (a coarse
    interleave in one process; the shared timeline prices both tenants'
    traffic over the same lanes).  Returns ``(ServeRun, TrainRun,
    report)``."""
    pool = HeteroMemory(device_capacity_bytes=shares.device_pool,
                        host_capacity_bytes=shares.host_pool, policy="opt",
                        device=device)
    pool.set_timeline(timeline)
    serve_t = pool.create_tenant(
        "serve", priority=SERVE_PRIORITY,
        device_budget_bytes=shares.serve_device,
        host_budget_bytes=shares.serve_host)
    train_t = pool.create_tenant("train")
    serve_eng = ServingEngine(model_class(serve_cfg), serve_cfg, pool=pool,
                              tenant=serve_t, init_params=serve_params,
                              **(serve_kw or {}))
    train_eng = PatrickStarEngine(model_class(train_cfg), train_cfg,
                                  pool=pool, tenant=train_t,
                                  device_memory_bytes=shares.train_device,
                                  init_params=train_params,
                                  **(train_kw or {}))
    rids = [serve_eng.submit(p, new_tokens) for p in prompts]
    rounds, steps = [], []
    while True:
        served = False
        for _ in range(SERVE_EVERY):
            m = serve_eng.step_round()
            if m is None:
                break
            served = True
            rounds.append(m)
            _check_serve_round(m, serve_t, pool,
                               (shares.serve_device, shares.serve_host))
            serve_eng.check_invariants()
        if len(steps) < len(batches):
            steps.append(train_eng.step(batches[len(steps)]))
        elif not served:
            break
    pool.check_invariants()
    report = {
        "serve_rounds": serve_eng.rounds,
        "train_steps": len(steps),
        "cross_evictions": {f"{v}<-{b}": n
                            for (v, b), n in sorted(pool.evictions.items())},
        "serve_peak_device_bytes": serve_t.peak_device_bytes,
        "train_peak_device_bytes": train_t.peak_device_bytes,
        "serve_h2d_bytes": serve_t.stats.h2d_bytes,
        "train_h2d_bytes": train_t.stats.h2d_bytes,
        "serve_d2h_bytes": serve_t.stats.d2h_bytes,
        "train_d2h_bytes": train_t.stats.d2h_bytes,
    }
    return (ServeRun([serve_eng.result(r) for r in rids], rounds, serve_eng),
            TrainRun([float(m.loss) for m in steps], steps, train_eng),
            report)


def static_split(serve_cfg, serve_params, prompts, new_tokens,
                 train_cfg, train_params, batches, shares: Shares, *,
                 timeline_factory: Callable[[], TransferTimeline], device,
                 serve_kw: dict | None = None, train_kw: dict | None = None):
    """The baseline: two private pools, each HALF the shared pool on both
    tiers.  Returns ``(ServeRun, TrainRun or None, oom)``: ``oom`` when the
    trainer's model data does not fit its half."""
    half_host = None if shares.host_pool is None else shares.host_pool // 2
    serve = solo_serving(serve_cfg, serve_params, prompts, new_tokens,
                         device_bytes=shares.device_pool // 2,
                         host_bytes=half_host, timeline=timeline_factory(),
                         device=device, **(serve_kw or {}))
    try:
        train = solo_training(train_cfg, train_params, batches,
                              device_bytes=shares.device_pool // 2,
                              host_bytes=half_host,
                              timeline=timeline_factory(), device=device,
                              **(train_kw or {}))
    except OutOfMemory:
        return serve, None, True
    return serve, train, False


# ---------------------------------------------------------------------------
# the fleets: a rank-parallel trainer beside a serving fleet, one pool a rank
# ---------------------------------------------------------------------------


def solo_serving_fleet(cfg, params, prompts, new_tokens, *, nproc: int,
                       device_bytes: int, host_bytes: int | None, device,
                       **serve_kw) -> ServeRun:
    """The serving fleet alone, each rank on a private pool of its
    share."""
    from repro_torch.core.distributed import DistributedServingEngine

    fleet = DistributedServingEngine(
        model_class(cfg), cfg, nproc=nproc, device=device,
        device_memory_bytes=device_bytes, host_memory_bytes=host_bytes,
        init_params=params, **serve_kw)
    gids = [fleet.submit(p, new_tokens) for p in prompts]
    rounds = fleet.run()
    fleet.check_invariants()
    return ServeRun([fleet.result(g) for g in gids], rounds, fleet)


def solo_training_fleet(cfg, params, batches, *, nproc: int,
                        device_bytes: int, device, **train_kw) -> TrainRun:
    """The rank-parallel trainer alone, each rank on a private pool of
    its share."""
    from repro_torch.core.distributed import DistributedPatrickStarEngine

    eng = DistributedPatrickStarEngine(
        model_class(cfg), cfg, nproc=nproc, device=device,
        device_memory_bytes=device_bytes, init_params=params, **train_kw)
    steps = [eng.step(b) for b in batches]
    eng.check_invariants()
    return TrainRun([float(m.loss) for m in steps], steps, eng)


def coresident_fleets(serve_cfg, serve_params, prompts, new_tokens,
                      train_cfg, train_params, batches, shares: Shares, *,
                      nproc: int, device, serve_kw: dict | None = None,
                      train_kw: dict | None = None):
    """A serving fleet and a rank-parallel trainer on ``nproc`` shared
    pools, one a rank (each simulated rank owns its own device): on every
    rank the server is the prioritised tenant with ``shares``' budgets and
    the trainer the budget-less one (``DistributedServingEngine`` and
    ``DistributedPatrickStarEngine``, ``pools=``/``tenants=``).  The fleet
    runs up to ``SERVE_EVERY`` rounds, then the trainer takes a step, as
    :func:`coresident` interleaves; every round checks each rank's serve
    tenant against its budgets and the priority shield.  Returns
    ``(ServeRun, TrainRun, report)``."""
    from repro_torch.core.distributed import (
        DistributedPatrickStarEngine,
        DistributedServingEngine,
    )

    pools = [HeteroMemory(device_capacity_bytes=shares.device_pool,
                          host_capacity_bytes=shares.host_pool,
                          policy="opt", device=device)
             for _ in range(nproc)]
    serve_t = [p.create_tenant("serve", priority=SERVE_PRIORITY,
                               device_budget_bytes=shares.serve_device,
                               host_budget_bytes=shares.serve_host)
               for p in pools]
    train_t = [p.create_tenant("train") for p in pools]
    fleet = DistributedServingEngine(
        model_class(serve_cfg), serve_cfg, nproc=nproc, device=device,
        device_memory_bytes=shares.serve_device, pools=pools,
        tenants=serve_t, init_params=serve_params, **(serve_kw or {}))
    trainer = DistributedPatrickStarEngine(
        model_class(train_cfg), train_cfg, nproc=nproc, device=device,
        device_memory_bytes=shares.train_device, pools=pools,
        tenants=train_t, init_params=train_params, **(train_kw or {}))
    gids = [fleet.submit(p, new_tokens) for p in prompts]
    budgets = (shares.serve_device, shares.serve_host)
    rounds, steps = [], []
    while True:
        served = False
        for _ in range(SERVE_EVERY):
            m = fleet.step_round()
            if m is None:
                break
            served = True
            rounds.append(m)
            for rm, tenant, pool in zip(m.rank_metrics, serve_t, pools):
                if rm is not None:
                    _check_serve_round(rm, tenant, pool, budgets)
        if len(steps) < len(batches):
            steps.append(trainer.step(batches[len(steps)]))
        elif not served:
            break
    # each serving rank's own invariants (the fleet's zero-collective
    # check reads the pool's ledger, which here books the trainer's)
    for core in fleet.ranks:
        core.check_invariants()
    trainer.check_invariants()
    report = {
        "serve_rounds": len(rounds),
        "train_steps": len(steps),
        "cross_evictions": [{f"{v}<-{b}": n for (v, b), n in
                             sorted(p.evictions.items())} for p in pools],
        "serve_peak_device_bytes": [t.peak_device_bytes for t in serve_t],
        "train_peak_device_bytes": [t.peak_device_bytes for t in train_t],
        "serve_h2d_bytes": [t.stats.h2d_bytes for t in serve_t],
        "train_h2d_bytes": [t.stats.h2d_bytes for t in train_t],
    }
    return (ServeRun([fleet.result(g) for g in gids], rounds, fleet),
            TrainRun([float(m.loss) for m in steps], steps, trainer),
            report)


def throughput(walls: list[float]) -> float:
    """Steps per second, the first (warm-up) step excluded."""
    tail = walls[1:] if len(walls) > 1 else walls
    if not tail:
        return 0.0
    return 1.0 / statistics.mean(tail)
