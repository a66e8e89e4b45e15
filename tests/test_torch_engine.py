"""The port's eager trainer (``repro_torch.core.engine``) against the
reference ``repro.core.engine.PatrickStarEngine`` on the same weights
(made with numpy from a seed) and the same batches (the copied
``make_batch_fn``), on the CPU.

Per step: the loss within 1e-5 (fp32; the same math summed in another
order), and every ``EngineMetrics`` byte and count identical — h2d/d2h,
the ADAM stage's, hidden/critical h2d, prefetch hits, demand misses and
the step's peak device bytes — as are the placement plan and the chunk
layout.  Cases: the quickstart config (gpt2-paper-1b smoke, fp32, 4 MB,
``opt``, batch 4x64) with the activation stream on and off, with
device-aware placement off, under lru and fifo, without prefetch; bf16
compute; qwen3-0.6b smoke; a budgeted tenant of a shared pool with a
telemetry hub; the ``strict_device_budget`` OOM point; and
``initialize_engine`` through the Listing-1 facade."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core.engine import PatrickStarEngine as RefEngine  # noqa: E402
from repro.core.memory import OutOfMemory as RefOOM  # noqa: E402
from repro.models.layers import AxisCtx  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    PatrickStarEngine,
    initialize_engine,
)
from repro_torch.core.memory import OutOfMemory  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402

COUNTERS = ("h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes", "prefetch_hits",
            "demand_misses", "peak_device_bytes")
LOSS_TOL = 1e-5
STEPS = 8
QUICKSTART = dict(device_memory_bytes=4_000_000, policy="opt", lr=1e-2)


def _configs(arch, **over):
    kw = dict(dict(param_dtype="float32", compute_dtype="float32"), **over)
    return (jax_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _batches(cfg, n, b=4, s=64):
    nxt = make_batch_fn(cfg, b, s)
    return [{k: v for k, v in nxt().items() if k != "mask"}
            for _ in range(n)]


def _run(eng, batches):
    out = []
    for batch in batches:
        m = eng.step(batch)
        out.append((m.loss, {f: getattr(m, f) for f in COUNTERS}))
    return out


def _plan(eng):
    return None if eng.placement is None else dataclasses.asdict(
        eng.placement)


def _both(arch, steps=STEPS, cfg_over=None, **kw):
    """Reference and port engines on the same weights; returns the two
    engines and their per-step (loss, counters)."""
    jcfg, cfg = _configs(arch, **(cfg_over or {}))
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    batches = _batches(cfg, steps)
    ref = RefEngine(jax_model_class(jcfg), jcfg, init_params=params, **kw)
    port = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                             init_params=params_from_jax(params), **kw)
    return ref, port, _run(ref, batches), _run(port, batches)


def _assert_equal_runs(ref, port, want, got):
    assert len(got) == len(want)
    for step, ((lw, cw), (lg, cg)) in enumerate(zip(want, got)):
        assert np.isfinite(lg)
        assert abs(lg - lw) <= LOSS_TOL, (step, lg, lw)
        assert cg == cw, step
    assert _plan(port) == _plan(ref)
    assert [(p.name, p.chunk_id, p.offset) for p in port.cmap.placements] \
        == [(p.name, p.chunk_id, p.offset) for p in ref.cmap.placements]
    port.pool.check_invariants()


@pytest.fixture(scope="module")
def quickstart():
    return _both("gpt2-paper-1b", **QUICKSTART)


def test_quickstart_matches_reference(quickstart):
    ref, port, want, got = quickstart
    _assert_equal_runs(ref, port, want, got)
    # the config really pages, places ADAM on the device and prefetches
    assert port.placement.os_device_groups >= 1
    assert sum(c["h2d_bytes"] + c["adam_h2d_bytes"] for _, c in got) > 0
    assert sum(c["prefetch_hits"] for _, c in got) > 0


@pytest.mark.parametrize("case", [
    dict(manage_activations=False),
    dict(device_aware_placement=False),
    dict(policy="lru"),
    dict(policy="fifo"),
    dict(prefetch=False),
], ids=["act-stream-off", "placement-off", "lru", "fifo", "no-prefetch"])
def test_options_match_reference(case):
    _assert_equal_runs(*_both("gpt2-paper-1b", steps=4,
                              **dict(QUICKSTART, **case)))


def test_shared_pool_tenant_and_telemetry_match_reference():
    """The trainer as one budgeted tenant of a shared pool, with a
    telemetry hub: the same counters, and the same events and per-step
    snapshots on the hub."""
    from repro.core.memory import HeteroMemory as RefPool
    from repro.core.telemetry import Telemetry as RefHub
    from repro_torch.core.memory import HeteroMemory
    from repro_torch.core.telemetry import Telemetry

    jcfg, cfg = _configs("gpt2-paper-1b")
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    batches = _batches(cfg, 3)
    runs = []
    for pool_cls, hub_cls, make in (
            (RefPool, RefHub, lambda **kw: RefEngine(
                jax_model_class(jcfg), jcfg, init_params=params, **kw)),
            (HeteroMemory, Telemetry, lambda **kw: PatrickStarEngine(
                model_class(cfg), cfg, init_params=params_from_jax(params),
                **kw))):
        extra = {} if pool_cls is RefPool else {"device": "cpu"}
        pool = pool_cls(device_capacity_bytes=8_000_000, policy="opt",
                        **extra)
        tenant = pool.create_tenant("train", priority=1,
                                    device_budget_bytes=4_000_000)
        hub = hub_cls()
        eng = make(pool=pool, tenant=tenant, telemetry=hub, lr=1e-2)
        runs.append((eng, _run(eng, batches), hub))
    (ref, want, ref_hub), (port, got, hub) = runs
    _assert_equal_runs(ref, port, want, got)
    assert [(e.kind, e.name, e.stream, e.chunk_id, e.nbytes)
            for e in hub.events] == \
        [(e.kind, e.name, e.stream, e.chunk_id, e.nbytes)
         for e in ref_hub.events]
    drop = {"loss"}
    assert [{k: v for k, v in snap.items() if k not in drop}
            for snap in hub.snapshots] == \
        [{k: v for k, v in snap.items() if k not in drop}
         for snap in ref_hub.snapshots]


def test_act_stream_on_off_same_losses(quickstart):
    _, _, _, on = quickstart
    jcfg, cfg = _configs("gpt2-paper-1b")
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    off = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                            init_params=params_from_jax(params),
                            manage_activations=False, **QUICKSTART)
    for (a, _), (b, _) in zip(on, _run(off, _batches(cfg, STEPS))):
        assert abs(a - b) <= 1e-6


def test_bf16_compute_matches_reference():
    """bf16 params and compute (the full-size training slice's dtypes):
    the counters stay identical; the losses agree to bf16 precision
    (2e-2: activations round to bf16 at other places in the two
    frameworks)."""
    ref, port, want, got = _both("gpt2-paper-1b", steps=4, cfg_over=dict(
        param_dtype="bfloat16", compute_dtype="bfloat16"), **QUICKSTART)
    for (lw, cw), (lg, cg) in zip(want, got):
        assert abs(lg - lw) <= 2e-2 and cg == cw
    assert _plan(port) == _plan(ref)
    port.pool.check_invariants()


def test_qwen3_matches_reference():
    _assert_equal_runs(*_both("qwen3-0.6b", steps=4, **QUICKSTART))


@pytest.mark.parametrize("budget,oom_at", [(2_800_000, 1),
                                           (3_000_000, None)])
def test_strict_device_budget_oom_point_matches_reference(budget, oom_at):
    """Under ``strict_device_budget`` a budget whose chunkable memory
    leaves less than one operator's working set raises at the first
    post-warm-up step, and one just above it trains — in both packages
    alike."""
    jcfg, cfg = _configs("gpt2-paper-1b")
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    kw = dict(device_memory_bytes=budget, manage_activations=False,
              strict_device_budget=True)
    batches = _batches(cfg, 3)

    def oom_step(eng, exc):
        for i, batch in enumerate(batches):
            try:
                eng.step(batch)
            except exc:
                return i
        return None

    ref = RefEngine(jax_model_class(jcfg), jcfg, init_params=params, **kw)
    port = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                             init_params=params_from_jax(params), **kw)
    assert oom_step(ref, RefOOM) == oom_step(port, OutOfMemory) == oom_at


def test_initialize_engine_facade(quickstart):
    """Paper Listing 1 through the port's facade gives the reference's
    quickstart run."""
    _, _, want, _ = quickstart
    jcfg, cfg = _configs("gpt2-paper-1b")
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    model, optimizer = initialize_engine(
        model_func=lambda: (model_class(cfg), cfg),
        config=dict(QUICKSTART, device="cpu",
                    init_params=params_from_jax(params)))
    for batch, (loss, counters) in zip(_batches(cfg, STEPS), want):
        optimizer.zero_grad()
        proxy = model(batch)
        model.backward(proxy)
        optimizer.step()
        assert abs(model.loss - loss) <= LOSS_TOL
        assert {f: getattr(model._metrics, f) for f in COUNTERS} == counters


def test_batches_match_reference_pipeline():
    from repro.data.pipeline import make_batch_fn as jax_batches

    jcfg, cfg = _configs("gpt2-paper-1b")
    a, b = make_batch_fn(cfg, 2, 16, seed=3), jax_batches(jcfg, 2, 16, seed=3)
    for _ in range(2):
        x, y = a(), b()
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_entry_point_runs_on_cuda_or_raises():
    _, cfg = _configs("gpt2-paper-1b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        PatrickStarEngine(model_class(cfg), cfg, device_memory_bytes=1 << 30)
