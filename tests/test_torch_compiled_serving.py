"""The port's compiled serving plane (``repro_torch.runtime.serve.
CompiledServingEngine``) against the reference's on the same weights, on
the CPU: tokens, per-round memory counters, the padded-slot compile
counts and the slot page-id ranges, unpaged, paged, as a 2-rank fleet and
with telemetry; and K2's per-row lengths (``kv_lens``), the decode the
round step runs, against the reference's masked decode.  Twins of
``tests/test_compiled_serving.py``'s tier-1 cases,
``test_paged_serving.py``'s paged compiled case,
``test_distributed_serving.py``'s compiled fleet and
``test_telemetry.py``'s serving burst."""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core.distributed import (  # noqa: E402
    DistributedServingEngine as RefFleet,
)
from repro.core.telemetry import Telemetry as RefHub  # noqa: E402
from repro.core.timeline import TransferTimeline as RefTimeline  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.layers import AxisCtx  # noqa: E402
from repro.runtime.serve import CompiledServingEngine as RefCompiled  # noqa: E402
from _torch_parity import numpy_params, reference_hardware  # noqa: E402
from repro_torch.analysis import tracereport  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.chunk import (  # noqa: E402
    ChunkMapError,
    DynamicChunkMap,
    TensorSpec,
)
from repro_torch.core.distributed import (  # noqa: E402
    DistributedServingEngine,
)
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.core.timeline import TransferTimeline  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    flash_attention_ref,
    flash_attention_splitkv_ref,
)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.serve import CompiledServingEngine  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")
COUNTERS = ("admitted", "completed", "active", "queued", "prefill_tokens",
            "decode_tokens", "h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
            "critical_h2d_bytes", "prefetch_hits", "demand_misses",
            "peak_device_bytes")
BUDGET = dict(device_memory_bytes=1_300_000, host_memory_bytes=8_000_000)
# staggered lifetimes: early completions churn the slot set and leave the
# survivors decoding from different positions (the per-row path)
NEW_TOKENS = [8, 3, 8, 5, 8, 8]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("qwen3-0.6b", smoke=True).replace(**FP32)
    cfg = get_config("qwen3-0.6b", smoke=True).replace(**FP32)
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(6)]
    return jcfg, cfg, params, prompts


def _rounds(eng):
    """Step to the end; per round the counters and the live kv pages'
    chunk ids by name."""
    rows = []
    while True:
        m = eng.step_round()
        if m is None:
            return rows
        assert m.peak_device_bytes <= eng.device_capacity
        live = ({} if eng.kv_mgr is None else
                {p.name: p.chunk_id for p in eng.kv_mgr.cmap.placements})
        rows.append(({f: getattr(m, f) for f in COUNTERS}, live))


def _port(cls, setup, **kw):
    _, cfg, params, _ = setup
    return cls(model_class(cfg), cfg, device="cpu",
               init_params=params_from_jax(params), **BUDGET, **kw)


def _run(eng, prompts, news):
    rids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    rows = _rounds(eng)
    eng.check_invariants()
    return [eng.result(r) for r in rids], rows


# ---------------------------------------------------------------------------
# the compiled round against the reference's, and against the eager engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page_tokens", [None, 8])
def test_compiled_round_matches_reference_and_eager(setup, page_tokens):
    """Tokens, every per-round counter, the live kv pages' chunk ids, the
    compile counts and the padded slots equal the reference's compiled
    engine; tokens equal the port's eager engine, and the counters equal
    the eager engine's run one sequence a decode call (the replay pins one
    kv page at a time, as the reference's does)."""
    jcfg, cfg, params, prompts = setup
    kw = dict(max_seq_len=40 if page_tokens else 24, page_tokens=page_tokens)
    ref = RefCompiled(jax_model_class(jcfg), jcfg, init_params=params,
                      **BUDGET, **kw)
    port = _port(CompiledServingEngine, setup, **kw)
    want, ref_rows = _run(ref, prompts, NEW_TOKENS)
    got, rows = _run(port, prompts, NEW_TOKENS)
    assert got == want
    assert len(rows) == len(ref_rows)
    for i, (a, b) in enumerate(zip(ref_rows, rows)):
        assert b == a, i
    assert (port.decode_compile_count, port.prefill_compile_count,
            port.padded_slots) == (ref.decode_compile_count,
                                   ref.prefill_compile_count,
                                   ref.padded_slots) == (1, 1, 8)
    assert port.pool.stats.d2h_bytes > 0  # the budget paged
    eager_tokens, _ = _run(_port(ServingEngine, setup, **kw), prompts,
                           NEW_TOKENS)
    assert eager_tokens == got
    one = _port(ServingEngine, setup, max_decode_batch=1,
                max_prefill_batch=port.max_prefill_batch, **kw)
    one_tokens, one_rows = _run(one, prompts, NEW_TOKENS)
    assert one_tokens == got
    assert [r[0] for r in one_rows] == [r[0] for r in rows]


def test_no_recompile_on_membership_change(setup):
    """Admission and retire churn within one padded shape never rebuild
    the round step: it keys only on the padded slot count."""
    _, _, _, prompts = setup
    comp = _port(CompiledServingEngine, setup, max_seq_len=24)
    _run(comp, prompts, NEW_TOKENS)
    # 6 concurrent sequences pad to 8; completions re-bind slots without
    # crossing a power of two
    assert comp.padded_slots == 8
    assert comp.decode_compile_count == 1
    # a second wave after a full drain reuses every step
    first = [comp.result(r) for r in range(len(prompts))]
    again, _ = _run(comp, prompts, NEW_TOKENS)
    assert comp.decode_compile_count == 1
    assert again == first


def test_padded_slots_grow_by_powers_of_two_and_keep_rows(setup):
    """Admissions that cross a power of two re-make the slot caches one
    size up (2 -> 4 -> 8) with the live rows kept, and build one step per
    shape; tokens stay the eager engine's."""
    _, _, _, prompts = setup
    comp = _port(CompiledServingEngine, setup, max_seq_len=24)
    eager = _port(ServingEngine, setup, max_seq_len=24)
    shapes = []
    for eng in (comp, eager):
        rids = []
        for i, p in enumerate(prompts):  # one more sequence each round
            rids.append(eng.submit(p, 8))
            eng.step_round()
            if eng is comp:
                shapes.append(comp.padded_slots)
        eng.run()
        if eng is comp:
            got = [eng.result(r) for r in rids]
    assert shapes == [2, 2, 4, 4, 8, 8]
    assert comp.decode_compile_count == 3  # 2, 4 and 8 slots
    assert got == [eager.result(r) for r in range(len(prompts))]


def test_slot_chunk_binding_is_stable_across_rebinds(setup):
    """Slot s always maps to chunk ids [s*L, (s+1)*L): the kv id space is
    bounded by the padded-slot high-water mark however many sequences
    churn through, and re-admission after a drain walks the same ids."""
    _, _, _, prompts = setup
    comp = _port(CompiledServingEngine, setup, max_seq_len=24)
    _run(comp, prompts, NEW_TOKENS)
    total_layers = comp._total_layers
    for p, n in zip(prompts, NEW_TOKENS):
        comp.submit(p, n)
    comp.step_round()
    cm = comp.kv_mgr.cmap
    for pl in cm.placements:
        slot = comp._slot_of[int(pl.name.split(".")[1])]
        assert slot * total_layers <= pl.chunk_id < (slot + 1) * total_layers
    assert cm.num_chunks <= comp.peak_concurrency * total_layers
    comp.run()
    comp.check_invariants()


def test_paged_compiled_matches_oracle_and_pins_page_ranges(setup):
    """Paged compiled serving gives the unpaged eager engine's tokens, and
    every live kv page sits in its slot's reserved id range each round."""
    _, cfg, _, _ = setup
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(4)]
    news = [9, 4, 9, 6]
    oracle, _ = _run(_port(ServingEngine, setup, max_seq_len=40), prompts,
                     news)
    comp = _port(CompiledServingEngine, setup, max_seq_len=40,
                 page_tokens=8)
    rids = [comp.submit(p, n) for p, n in zip(prompts, news)]
    stepped = False
    while comp.step_round() is not None:
        stepped = True
        if comp.kv_mgr is not None:
            for pl in comp.kv_mgr.cmap.placements:
                r = driver.slot_page_range(
                    comp._slot_of[int(pl.name.split(".")[1])],
                    comp._total_layers, comp._pages_per_seq)
                assert pl.chunk_id in r, (pl.name, pl.chunk_id, r)
        comp.check_invariants()
    assert stepped
    assert [comp.result(r) for r in rids] == oracle


def test_compiled_refuses_unmanaged_kv(setup):
    with pytest.raises(ValueError, match="managed kv stream"):
        _port(CompiledServingEngine, setup, max_seq_len=24, manage_kv=False)


# ---------------------------------------------------------------------------
# the compiled fleet, and telemetry
# ---------------------------------------------------------------------------


def test_fleet_compiled_matches_reference_fleet_and_eager_oracle():
    """A 2-rank compiled paged fleet: the reference's compiled fleet's
    tokens and per-rank counters round by round, the eager paged oracle's
    tokens, and zero collective bytes."""
    jcfg = jax_config("qwen3-0.6b", smoke=True).replace(**FP32)
    cfg = get_config("qwen3-0.6b", smoke=True).replace(**FP32)
    params = params_from_jax(jax.tree.map(
        np.asarray, jax_model_class(jcfg)(jcfg, AxisCtx()).init_params(
            jax.random.key(0))))
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(4)]
    news = [8, 4, 8, 6]
    kw = dict(BUDGET, max_seq_len=40, page_tokens=8)
    oracle = ServingEngine(model_class(cfg), cfg, device="cpu",
                           init_params=params, **kw)
    want = [oracle.submit(p, n) for p, n in zip(prompts, news)]
    oracle.run()
    want = [oracle.result(r) for r in want]
    ref = RefFleet(jax_model_class(jcfg), jcfg, nproc=2, compiled=True, **kw)
    fleet = DistributedServingEngine(model_class(cfg), cfg, nproc=2,
                                     device="cpu", compiled=True,
                                     init_params=params, **kw)
    assert all(isinstance(c, CompiledServingEngine) for c in fleet.ranks)
    gids = [fleet.submit(p, n) for p, n in zip(prompts, news)]
    assert gids == [ref.submit(p, n) for p, n in zip(prompts, news)]
    ref_mets, mets = ref.run(), fleet.run()
    fleet.check_invariants()
    assert [fleet.result(g) for g in gids] == want
    assert [ref.result(g) for g in gids] == want
    assert len(mets) == len(ref_mets)
    for a, b in zip(ref_mets, mets):
        for ra, rb in zip(a.rank_metrics, b.rank_metrics):
            assert (rb is None) == (ra is None)
            if ra is not None:
                assert {f: getattr(rb, f) for f in COUNTERS} == \
                    {f: getattr(ra, f) for f in COUNTERS}, a.round_index
    assert [c.padded_slots for c in fleet.ranks] == \
        [c.padded_slots for c in ref.ranks]


def test_compiled_serving_telemetry_matches_reference(setup):
    """A compiled serving burst on a timeline with a hub: the port's events
    (the ``compiled`` track's ``compute`` then ``replay`` span a round,
    every move and stall, timestamps on the simulated clock) and per-round
    snapshots equal the reference's; bytes and stalls are conserved and
    every span closes."""
    jcfg, cfg, params, prompts = setup
    hubs = [RefHub(), Telemetry()]
    ref = RefCompiled(
        jax_model_class(jcfg), jcfg, init_params=params,
        device_memory_bytes=1_200_000, host_memory_bytes=8_000_000,
        max_seq_len=24, telemetry=hubs[0],
        timeline=RefTimeline(h2d_bandwidth=2e8, d2h_bandwidth=2e8))
    port = CompiledServingEngine(
        model_class(cfg), cfg, device="cpu",
        init_params=params_from_jax(params),
        device_memory_bytes=1_200_000, host_memory_bytes=8_000_000,
        max_seq_len=24, telemetry=hubs[1],
        timeline=TransferTimeline(h2d_bandwidth=2e8, d2h_bandwidth=2e8,
                                  hardware=reference_hardware()))
    results = []
    for eng in (ref, port):
        rids = [eng.submit(p, 5) for p in prompts[:4]]
        rounds = list(eng.run())
        eng.check_invariants()
        results.append(([eng.result(r) for r in rids], len(rounds)))
    assert results[1] == results[0]
    ref_hub, hub = hubs
    assert len(hub.events) == len(ref_hub.events) > 0
    for a, b in zip(ref_hub.events, hub.events):
        assert dataclasses.asdict(b) == dataclasses.asdict(a), a.seq
    assert hub.snapshots == ref_hub.snapshots
    hub.assert_conservation()
    hub.assert_balanced_spans()
    spans = [e.attrs["label"] for e in hub.events if e.kind == "span"
             and e.name.endswith("compiled") and e.attrs["ph"] == "B"]
    assert spans == ["compute", "replay"] * results[1][1]
    assert len([s for s in hub.snapshots if ":round" in s["label"]]) \
        == results[1][1]
    trace = hub.chrome_trace()
    assert trace["otherData"]["clock"] == "timeline"
    tracereport.validate(trace)


# ---------------------------------------------------------------------------
# DynamicChunkMap explicit-id binding (the slot page ranges rely on it)
# ---------------------------------------------------------------------------


def test_dynamic_map_slot_binding_property_under_churn():
    """Randomised bind/complete traffic with the engine's lowest-free-slot
    rule: live chunks match the live slots, the id space stays within the
    slot high-water mark, every tensor sits in its slot's range, and
    binding into an occupied chunk refuses."""
    layers = 3
    rng = random.Random(0)
    for _ in range(20):
        dm = DynamicChunkMap(64)
        live: dict[int, list[str]] = {}
        high_water = 0
        next_rid = 0
        for _ in range(60):
            if live and (rng.random() < 0.45 or len(live) >= 6):
                for n in live.pop(rng.choice(sorted(live))):
                    dm.remove_tensor(n)
            else:
                slot = next(s for s in range(len(live) + 1)
                            if s not in live)
                rid, next_rid = next_rid, next_rid + 1
                names = []
                for j in range(layers):
                    p = dm.add_tensor(TensorSpec(f"kv.{rid}.{j}", (32,)),
                                      chunk_id=slot * layers + j)
                    assert p.chunk_id == slot * layers + j
                    names.append(p.name)
                live[slot] = names
                high_water = max(high_water, len(live))
            assert dm.num_payload_chunks == len(live) * layers
            assert dm.num_chunks <= high_water * layers
            for slot, names in live.items():
                for j, n in enumerate(names):
                    assert dm.placement(n).chunk_id == slot * layers + j
            if live:
                with pytest.raises(ChunkMapError):
                    dm.add_tensor(TensorSpec("dup", (1,)),
                                  chunk_id=next(iter(live)) * layers)


def test_dynamic_map_explicit_id_interops_with_default_alloc():
    dm = DynamicChunkMap(16)
    assert dm.add_tensor(TensorSpec("a", (16,)), chunk_id=2).chunk_id == 2
    # ids 0 and 1 opened below the new high-water mark: default
    # allocation recycles them before growing the id space
    b = dm.add_tensor(TensorSpec("b", (8,)))
    c = dm.add_tensor(TensorSpec("c", (8,)))
    assert {b.chunk_id, c.chunk_id} == {0, 1}
    assert dm.add_tensor(TensorSpec("d", (8,))).chunk_id == 3
    assert dm.num_chunks == 4
    dm.remove_tensor("a")
    assert dm.add_tensor(TensorSpec("e", (4,)), chunk_id=2).chunk_id == 2
    with pytest.raises(ChunkMapError):
        dm.add_tensor(TensorSpec("f", (4,)), chunk_id=-1)


# ---------------------------------------------------------------------------
# K2's per-row lengths: the plan at the horizon and the plain version
# ---------------------------------------------------------------------------

LENGTHS = (1, 37, 64, 65, 500, 512, 1023, 1024)  # horizon 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [2, 4, 8])
def test_plan_covers_the_horizon_for_per_row_lengths(b, dtype):
    """With lengths only on the device the call passes no host length and
    no causal cut: the splits cover [0, Sk) exactly once, whole 64-row
    tiles, so a row of length 1 leaves all splits but the first empty."""
    plan = fa.plan_forward(b, 1, 1024, 16, dtype, causal=False)
    assert plan.schedule == "splitkv" and plan.split_lo == 0
    assert plan.split_rows % fa.SPLIT_GRAIN == 0
    assert (plan.splits - 1) * plan.split_rows < 1024 \
        <= plan.splits * plan.split_rows
    assert plan.splits > 1


def _qkv(seed, b, c, h, kv, d, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype) for shape in
            ((b, 1, h, d), (b, c, kv, d), (b, c, kv, d))]


@pytest.mark.parametrize("kv", [4, 2])
def test_plain_kv_lens_matches_reference_masked_decode(kv):
    """Row b of the plain version with ``kv_lens`` equals the reference's
    masked decode softmax (``jnp.arange(C) < pos + 1``) at its own
    position."""
    q, k, v = _qkv(0, len(LENGTHS), 1024, 4, kv, 32)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    got = flash_attention_ref(q, k, v, causal=False, kv_lens=lens)
    for b, n in enumerate(LENGTHS):
        want = jax_layers._decode_attend(
            jnp.asarray(q[b:b + 1].numpy()), jnp.asarray(k[b:b + 1].numpy()),
            jnp.asarray(v[b:b + 1].numpy()), jnp.arange(1024) < n)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splitkv_arithmetic_with_kv_lens_weighs_empty_splits_zero(dtype):
    """The split-kv arithmetic over the horizon plan with per-row lengths
    (most splits of the short rows empty) equals the plain version: no
    NaN, the empty splits weigh exactly 0."""
    q, k, v = _qkv(1, len(LENGTHS), 1024, 4, 2, 32, dtype)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    plan = fa.plan_forward(len(LENGTHS), 1, 1024, 4, dtype, causal=False)
    got, lse = flash_attention_splitkv_ref(
        q, k, v, splits=plan.splits, split_lo=plan.split_lo,
        split_rows=plan.split_rows, causal=False, kv_lens=lens,
        return_lse=True)
    want, want_lse = flash_attention_ref(q, k, v, causal=False, kv_lens=lens,
                                         return_lse=True)
    assert torch.isfinite(got.float()).all() and torch.isfinite(lse).all()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-4


def test_kv_lens_is_checked_before_any_launch():
    """The wrapper's checks run before the kernel is built or launched, so
    they hold here: kv_lens only on the decode schedule, int32 [B] on q's
    device."""
    q = torch.zeros((2, 1, 4, 32))
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="decode"):
        fa._check_kv_lens(torch.zeros((2, 16, 4, 32)), lens, 16)
    with pytest.raises(TypeError, match="int32"):
        fa._check_kv_lens(q, lens.long(), 1)
    with pytest.raises(ValueError, match=r"\[B\]"):
        fa._check_kv_lens(q, torch.ones(3, dtype=torch.int32), 1)
    fa._check_kv_lens(q, lens, 1)


@pytest.mark.parametrize("arch", ["gpt2-paper-1b", "qwen3-0.6b"])
def test_layer_decode_per_row_positions_equals_batch1_decodes(arch):
    """The slot path of ``attention_decode`` (a [B] position tensor) gives
    every row what a batch-1 int-position decode of it gives, and writes
    row b's k/v at its position into the cache in place."""
    cfg = get_config(arch, smoke=True).replace(**FP32)
    g = torch.Generator().manual_seed(3)
    p = L.init_attention(g, cfg)
    pos = torch.tensor([0, 5, 11, 3])
    b, c = len(pos), 16
    x = torch.randn((b, 1, cfg.d_model), generator=g)
    cache = {n: torch.randn((b, c, cfg.n_kv_heads, cfg.head_dim),
                            generator=g) for n in ("k", "v")}
    before = {n: t.clone() for n, t in cache.items()}
    y, new = L.attention_decode(p, x, cache, pos, cfg, L.AxisCtx())
    assert new["k"] is cache["k"] and new["v"] is cache["v"]
    for i, n in enumerate(pos.tolist()):
        row = {k: t[i:i + 1] for k, t in before.items()}
        yi, ci = L.attention_decode(p, x[i:i + 1], row, n, cfg, L.AxisCtx())
        torch.testing.assert_close(y[i:i + 1], yi, rtol=1e-6, atol=1e-6)
        for k in ("k", "v"):
            torch.testing.assert_close(cache[k][i:i + 1], ci[k])
