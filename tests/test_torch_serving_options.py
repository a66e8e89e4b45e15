"""The port's ``ServingEngine`` options against the reference's, on the
same weights (made with numpy from a seed), on the CPU:

  * the transfer timeline (twins of ``tests/test_timeline.py``'s serving
    cases): every round's ``StepTimeline`` identical, with bandwidth-aware
    prefetch on and off, paged and unpaged;
  * a shared pool with a budgeted tenant and a telemetry hub on a
    calibrated timeline: tokens, counters, every telemetry event (its
    simulated timestamp included) and every per-round snapshot identical;
    the hub's Chrome trace passes the port's own trace reader;
  * ``manage_kv=False``, the unmanaged baseline (twins of
    ``tests/test_serving_engine.py``'s managed-vs-unmanaged cases): the
    same tokens, admission and device reservation as the reference's;
    paged + unmanaged raises;
  * tenant-scoped staging: one tenant's prefetch never reclaims another's
    device residency (twin of ``tests/test_tenants.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core.memory import HeteroMemory as RefPool  # noqa: E402
from repro.core.serving import ServingEngine as RefServing  # noqa: E402
from repro.core.telemetry import Telemetry as RefHub  # noqa: E402
from repro.core.timeline import TransferTimeline as RefTimeline  # noqa: E402
from repro.models.layers import AxisCtx  # noqa: E402
from _torch_parity import (  # noqa: E402
    numpy_params,
    reference_hardware,
    timeline_fields,
)
from repro_torch.analysis import tracereport  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.memory import HeteroMemory  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.core.timeline import TransferTimeline  # noqa: E402

HW = reference_hardware()
FP32 = dict(param_dtype="float32", compute_dtype="float32")
ROUND = ("admitted", "completed", "active", "queued", "prefill_tokens",
         "decode_tokens", "h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
         "critical_h2d_bytes", "prefetch_hits", "demand_misses",
         "peak_device_bytes")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("qwen3-0.6b", smoke=True).replace(**FP32)
    cfg = get_config("qwen3-0.6b", smoke=True).replace(**FP32)
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    return jcfg, cfg, params


def _pair(setup, ref_kw=None, port_kw=None, **kw):
    jcfg, cfg, params = setup
    ref = RefServing(jax_model_class(jcfg), jcfg, init_params=params,
                     **dict(kw, **(ref_kw or {})))
    port = ServingEngine(model_class(cfg), cfg, device="cpu",
                         init_params=params_from_jax(params),
                         **dict(kw, **(port_kw or {})))
    return ref, port


def _lanes(**bw):
    return (dict(timeline=RefTimeline(**bw)),
            dict(timeline=TransferTimeline(hardware=HW, **bw)))


def _serve_both(ref, port, prompts, new_tokens):
    """Serve the burst on both; every round's counters and timeline must
    be equal, and every request's tokens."""
    for p in prompts:
        assert ref.submit(p, new_tokens) == port.submit(p, new_tokens)
    want, got = ref.run(max_rounds=300), port.run(max_rounds=300)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert {f: getattr(b, f) for f in ROUND} == \
            {f: getattr(a, f) for f in ROUND}, a.round_index
        assert timeline_fields(b.timeline) == timeline_fields(a.timeline), \
            a.round_index
        if b.timeline is not None:
            t = b.timeline
            assert abs(t.wall_s - t.step_s) <= 1e-9 * max(t.wall_s, 1e-30)
    for rid in range(len(prompts)):
        assert port.result(rid) == ref.result(rid)
    port.check_invariants()
    return got


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


# ---------------------------------------------------------------------------
# the transfer timeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aware,page_tokens", [(True, 4), (False, None)],
                         ids=["aware-paged", "fixed-unpaged"])
def test_timeline_rounds_match_reference(setup, aware, page_tokens):
    ref_kw, port_kw = _lanes(h2d_bandwidth=5e8, d2h_bandwidth=5e8)
    ref, port = _pair(setup, ref_kw, port_kw, device_memory_bytes=1_200_000,
                      host_memory_bytes=8_000_000, max_seq_len=24,
                      page_tokens=page_tokens,
                      bandwidth_aware_prefetch=aware)
    got = _serve_both(ref, port, _prompts(setup[1], (8, 8, 6)), 6)
    assert sum(m.timeline.compute_s for m in got) > 0.0
    assert sum(m.timeline.stall_s for m in got) > 0.0


def test_timeline_infinite_bandwidth_zero_stall(setup):
    ref, port = _pair(setup, *_lanes(), device_memory_bytes=1_200_000,
                      host_memory_bytes=8_000_000, max_seq_len=24)
    got = _serve_both(ref, port, _prompts(setup[1], (8,)), 4)
    assert all(m.timeline.stall_s == 0.0 for m in got)


def test_without_timeline_reports_none(setup):
    _, port = _pair(setup, device_memory_bytes=1_200_000, max_seq_len=16)
    port.submit(np.arange(4) % setup[1].vocab_size, 2)
    assert all(m.timeline is None for m in port.run())


# ---------------------------------------------------------------------------
# a shared pool, a tenant and a telemetry hub
# ---------------------------------------------------------------------------


def test_shared_pool_tenant_and_telemetry_match_reference(setup, tmp_path):
    """The engine as a budgeted, prioritised tenant of a shared pool on a
    calibrated timeline, its budget below the param stream so it pages:
    the hub's events (timestamps on the simulated clock included) and its
    per-round snapshots are the reference's."""
    engines, hubs = [], []
    for pool_cls, hub_cls, tl, extra in (
            (RefPool, RefHub, RefTimeline.calibrated(), {}),
            (HeteroMemory, Telemetry, TransferTimeline.calibrated(HW),
             {"device": "cpu"})):
        pool = pool_cls(device_capacity_bytes=2_000_000,
                        host_capacity_bytes=12_000_000, policy="opt",
                        **extra)
        pool.set_timeline(tl)
        tenant = pool.create_tenant("serve", priority=10,
                                    device_budget_bytes=1_200_000,
                                    host_budget_bytes=8_000_000)
        hub = hub_cls()
        kw = dict(pool=pool, tenant=tenant, telemetry=hub, max_seq_len=24,
                  page_tokens=4)
        engines.append(kw)
        hubs.append(hub)
    ref, port = _pair(setup, engines[0], engines[1])
    got = _serve_both(ref, port, _prompts(setup[1], (8, 8, 6, 6)), 6)
    assert sum(m.h2d_bytes for m in got) > 0  # the budget paged
    ref_hub, hub = hubs
    assert len(hub.events) == len(ref_hub.events) > 0
    for a, b in zip(ref_hub.events, hub.events):
        assert dataclasses.asdict(b) == dataclasses.asdict(a), a.seq
    assert hub.snapshots == ref_hub.snapshots
    assert {e.name for e in hub.events if e.kind == "span"} >= {
        "serve:round", "serve:ops"}
    # the port's Chrome trace passes the port's own reader, whose counter
    # totals equal the pool's
    path = tmp_path / "trace.json"
    hub.dump_chrome_trace(str(path))
    tracereport.validate(tracereport.load(str(path)))
    assert "chunks by transferred bytes" in tracereport.report(tracereport.load(str(path)))
    assert tracereport.main([str(path), "--top", "3"]) == 0


# ---------------------------------------------------------------------------
# manage_kv=False: the unmanaged baseline
# ---------------------------------------------------------------------------


def test_unmanaged_kv_matches_reference(setup):
    """Whole-horizon raw caches on the engine's device, reserved out of
    the device budget: the reference's admission, rounds, counters,
    timelines and tokens."""
    ref_kw, port_kw = _lanes(h2d_bandwidth=5e8, d2h_bandwidth=5e8)
    ref, port = _pair(setup, ref_kw, port_kw, device_memory_bytes=1_200_000,
                      host_memory_bytes=None, max_seq_len=24,
                      manage_kv=False)
    assert port._kv_seq_raw_bytes == ref._kv_seq_raw_bytes > 0
    got = _serve_both(ref, port, _prompts(setup[1], [8] * 4, seed=4), 5)
    assert all(m.timeline.compute_s > 0.0 for m in got)
    assert port.peak_concurrency == ref.peak_concurrency


def test_managed_kv_at_least_doubles_concurrency(setup):
    """At a fixed tight device budget the managed kv stream (spillable to
    host) admits >= 2x the unmanaged baseline's concurrent sequences, with
    identical tokens (the reference's capacity bar, on the port)."""
    _, cfg, params = setup
    prompts = _prompts(cfg, [8] * 16, seed=4)

    def serve(manage_kv, host):
        eng = ServingEngine(model_class(cfg), cfg, device="cpu",
                            init_params=params_from_jax(params),
                            device_memory_bytes=1_200_000,
                            host_memory_bytes=host, max_seq_len=40,
                            manage_kv=manage_kv)
        rids = [eng.submit(p, 10) for p in prompts]
        eng.run(max_rounds=300)
        eng.check_invariants()
        return eng, [eng.result(r) for r in rids]

    managed, out_m = serve(True, 8_000_000)
    unmanaged, out_u = serve(False, None)
    assert out_m == out_u
    assert managed.peak_concurrency >= 2 * unmanaged.peak_concurrency, (
        managed.peak_concurrency, unmanaged.peak_concurrency)


def test_unmanaged_kv_reserves_device_budget(setup):
    _, port = _pair(setup, device_memory_bytes=1_200_000,
                    host_memory_bytes=None, max_seq_len=40, manage_kv=False)
    p = np.arange(8, dtype=np.int32) % setup[1].vocab_size
    for _ in range(12):
        port.submit(p, 6)
    while port.queued_count or port.active_count:
        port.step_round()
        assert port.device_bytes_in_use() <= port.device_capacity
        assert port._raw_kv_bytes == \
            port.active_count * port._kv_seq_raw_bytes
    assert port._raw_kv == {} and port._raw_kv_bytes == 0
    port.check_invariants()


def test_paged_unmanaged_raises(setup):
    _, cfg, _ = setup
    with pytest.raises(ValueError, match="manage_kv=True"):
        ServingEngine(model_class(cfg), cfg, device="cpu",
                      device_memory_bytes=1_200_000, manage_kv=False,
                      page_tokens=4)


# ---------------------------------------------------------------------------
# tenant-scoped staging
# ---------------------------------------------------------------------------


def test_staging_never_reclaims_other_tenants_residency():
    """A tenant's prefetch staging may only evict ITS OWN device
    residents: cross-tenant space is taken on the demand path (under the
    shield), never by the speculative staging path."""
    from repro_torch.core.chunk import TensorSpec, build_chunk_map
    from repro_torch.core.manager import ChunkManager
    from repro_torch.core.state import TensorState

    cb = 8 * 4

    def cmap(n):
        return build_chunk_map([TensorSpec(f"t{i}", (8,)) for i in range(n)],
                               8)

    def hold(mgr, i, dev="device"):
        mgr.access_tensor(f"t{i}", dev)
        mgr.release_tensor(f"t{i}", TensorState.HOLD_AFTER_FWD)

    pool = HeteroMemory(device_capacity_bytes=2 * cb,
                        host_capacity_bytes=8 * cb, policy="opt",
                        device="cpu")
    serve = pool.create_tenant("serve")
    kv = ChunkManager(cmap(2), name="kv", pool=pool, tenant=serve)
    train = ChunkManager(cmap(2), name="os", pool=pool)
    hold(train, 0)
    hold(train, 1)  # device full with default-tenant chunks
    hold(kv, 0, "host")  # serve's chunk parked on host
    kv.register_moments({0: [100]})
    train.register_moments({0: [500], 1: [600]})  # far, tempting victims
    assert pool.stage("serve:kv", 0) is False  # refused: not serve's space
    assert train.location(0) == "device" and train.location(1) == "device"
    assert pool.staged_count(serve) == 0
    pool.check_invariants()
