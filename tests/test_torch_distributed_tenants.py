"""The port's rank-parallel trainer as tenants of per-rank shared pools
(``DistributedPatrickStarEngine(pools=, tenants=)``) against the
reference's, on the CPU, with a serving fleet as the other tenant of the
same pools: each rank's trainer a budget-less tenant, each rank's server
a prioritised one with a device budget, the server running
``SERVE_EVERY`` rounds between two training steps (the co-tenancy
drivers' interleave, fleet-wide).  Both packages start from the
reference's own init; per step the losses agree within 1e-5 relative, and
each rank's pool counters (h2d and d2h bytes, evictions by tenant pair)
agree exactly, as do the served tokens and the point where a pool too
small for the trainer runs out of memory.  Written as
``test_fleet_as_tenants_of_shared_pools_matches_reference`` of
``tests/test_torch_distributed_serving.py`` is."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core.distributed import (  # noqa: E402
    DistributedPatrickStarEngine as RefDist,
)
from repro.core.distributed import (  # noqa: E402
    DistributedServingEngine as RefFleet,
)
from repro.core.memory import HeteroMemory as RefPool  # noqa: E402
from repro.core.memory import OutOfMemory as RefOOM  # noqa: E402
from repro.models.layers import AxisCtx  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistributedPatrickStarEngine,
    DistributedServingEngine,
)
from repro_torch.core.memory import HeteroMemory, OutOfMemory  # noqa: E402

LOSS_TOL = 1e-5  # relative, against the reference
NPROC = 2
SERVE_EVERY = 3
SERVE_BUDGET = 1_300_000  # the serve tenant's device budget, a rank
TRAIN_KW = dict(device_memory_bytes=4_000_000, lr=1e-2)
SERVE_KW = dict(device_memory_bytes=SERVE_BUDGET, max_seq_len=40,
                page_tokens=8)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _configs(arch):
    return (jax_config(arch, smoke=True).replace(**F32),
            get_config(arch, smoke=True).replace(**F32))


def _params(jcfg):
    params = jax_model_class(jcfg)(jcfg, AxisCtx()).init_params(
        jax.random.key(0))
    return params_from_jax(jax.tree.map(np.asarray, params))


def _batch(cfg, seed, b=4, s=32):
    tok = np.asarray(jax.random.randint(jax.random.key(seed), (b, s), 0,
                                        cfg.vocab_size))
    return {"tokens": tok, "labels": np.roll(tok, -1, 1),
            "global_tokens": np.float32(b * s)}


def _prompts(cfg, n, length):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab_size, size=length).tolist()
            for _ in range(n)]


def _pools(pool_cls, device_bytes, extra):
    """One shared pool a rank, each with a prioritised serve tenant and a
    budget-less train tenant."""
    pools = [pool_cls(device_capacity_bytes=device_bytes,
                      host_capacity_bytes=64_000_000, policy="opt",
                      **extra) for _ in range(NPROC)]
    serve = [p.create_tenant("serve", priority=10,
                             device_budget_bytes=SERVE_BUDGET)
             for p in pools]
    train = [p.create_tenant("train") for p in pools]
    return pools, serve, train


def _run(port: bool, device_bytes: int, steps: int = 2):
    """Both fleets on the per-rank pools of one package, interleaved:
    -> (losses, tokens, per-rank pool counters after each step, the step
    that ran out of memory or None)."""
    tcfg_j, tcfg = _configs("gpt2-paper-1b")
    scfg_j, scfg = _configs("qwen3-0.6b")
    batches = [_batch(tcfg_j, 1 + i) for i in range(steps)]
    if port:
        pools, serve, train = _pools(HeteroMemory, device_bytes,
                                     {"device": "cpu"})
        trainer = DistributedPatrickStarEngine(
            model_class(tcfg), tcfg, nproc=NPROC, device="cpu",
            pools=pools, tenants=train, init_params=_params(tcfg_j),
            **TRAIN_KW)
        fleet = DistributedServingEngine(
            model_class(scfg), scfg, nproc=NPROC, device="cpu",
            pools=pools, tenants=serve, init_params=_params(scfg_j),
            **SERVE_KW)
        oom = OutOfMemory
    else:
        pools, serve, train = _pools(RefPool, device_bytes, {})
        trainer = RefDist(jax_model_class(tcfg_j), tcfg_j, nproc=NPROC,
                          pools=pools, tenants=train, **TRAIN_KW)
        fleet = RefFleet(jax_model_class(scfg_j), scfg_j, nproc=NPROC,
                         pools=pools, tenants=serve, **SERVE_KW)
        oom = RefOOM
    assert all(c.tenant is t for c, t in zip(trainer.ranks, train))
    gids = [fleet.submit(p, 6) for p in _prompts(scfg, 4, 10)]
    losses, ledgers, oom_at = [], [], None
    for step, batch in enumerate(batches):
        for _ in range(SERVE_EVERY):
            m = fleet.step_round()
            if m is None:
                break
            for r in m.rank_metrics:
                assert r is None or r.peak_device_bytes <= SERVE_BUDGET
        try:
            losses.append(float(trainer.step(batch).loss))
        except oom:
            oom_at = step
            break
        ledgers.append([dict(h2d=p.stats.h2d_bytes, d2h=p.stats.d2h_bytes,
                             evictions=dict(p.evictions)) for p in pools])
        assert all(p.evictions[("serve", "train")] == 0 for p in pools)
    if oom_at is None:
        fleet.run()
    return losses, [fleet.result(g) for g in gids] if oom_at is None \
        else None, ledgers, oom_at


@pytest.mark.parametrize("device_bytes,oom", [(6_000_000, False),
                                              (4_000_000, True)],
                         ids=["fits", "oom"])
def test_trainer_fleet_as_tenants_of_shared_pools_matches_reference(
        device_bytes, oom):
    ref = _run(False, device_bytes)
    got = _run(True, device_bytes)
    assert (got[3] is not None) == oom
    assert got[3] == ref[3]  # the same step runs out of memory, or none
    assert len(got[0]) == len(ref[0])
    for a, b in zip(got[0], ref[0]):
        assert abs(a - b) <= LOSS_TOL * abs(b), (got[0], ref[0])
    assert got[1] == ref[1]  # the served tokens
    assert got[2] == ref[2]  # every rank's counters after every step


@pytest.mark.parametrize("arg", ["pools", "tenants"])
def test_trainer_refuses_wrong_length_pools_and_tenants(arg):
    jcfg, cfg = _configs("gpt2-paper-1b")
    pools, serve, _ = _pools(HeteroMemory, 12_000_000, {"device": "cpu"})
    kw = {"pools": pools[:1]} if arg == "pools" else {"tenants": serve[:1]}
    with pytest.raises(ValueError, match="one entry per rank"):
        DistributedPatrickStarEngine(model_class(cfg), cfg, nproc=NPROC,
                                     device="cpu", **kw, **TRAIN_KW)
    rpools, rserve, _ = _pools(RefPool, 12_000_000, {})
    rkw = {"pools": rpools[:1]} if arg == "pools" else {"tenants":
                                                         rserve[:1]}
    with pytest.raises(ValueError, match="one entry per rank"):
        RefDist(jax_model_class(jcfg), jcfg, nproc=NPROC, **rkw,
                **TRAIN_KW)


def test_fleet_pairing_holds_the_cotenancy_bars():
    """``repro_torch.cotenancy.coresident_fleets`` (chip_smoke's fleet
    pairing) at smoke size: the served tokens and the training losses
    exactly those of each fleet alone on private per-rank pools (bars 1
    and 4), the serve budgets held and no serve chunk evicted for the
    trainer on any rank (bar 2, checked every round inside)."""
    from repro_torch import cotenancy as co

    scfg_j, scfg = _configs("qwen3-0.6b")
    tcfg_j, tcfg = _configs("gpt2-paper-1b")
    sparams, tparams = _params(scfg_j), _params(tcfg_j)
    prompts = _prompts(scfg, 4, 10)
    batches = [_batch(tcfg_j, 1 + i) for i in range(2)]
    serve_kw = dict(max_seq_len=40, page_tokens=8)
    shares = co.Shares(serve_device=SERVE_BUDGET, serve_host=8_000_000,
                       train_device=4_000_000, device_pool=6_000_000,
                       host_pool=None)
    solo_s = co.solo_serving_fleet(scfg, sparams, prompts, 6, nproc=NPROC,
                                   device_bytes=SERVE_BUDGET,
                                   host_bytes=8_000_000, device="cpu",
                                   **serve_kw)
    solo_t = co.solo_training_fleet(tcfg, tparams, batches, nproc=NPROC,
                                    device_bytes=4_000_000, device="cpu")
    serve, trn, report = co.coresident_fleets(
        scfg, sparams, prompts, 6, tcfg, tparams, batches, shares,
        nproc=NPROC, device="cpu", serve_kw=serve_kw)
    assert serve.tokens == solo_s.tokens
    assert trn.losses == solo_t.losses
    assert report["train_steps"] == 2 and report["serve_rounds"] > 0
    assert all(r.get("serve<-train", 0) == 0
               for r in report["cross_evictions"])
    assert any(report["train_h2d_bytes"])  # the shared pools page
