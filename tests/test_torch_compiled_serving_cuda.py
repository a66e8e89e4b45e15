"""The compiled serving plane on the card: K2's decode with per-row
lengths from device memory (``kv_lens``) against its plain version, also
captured in a CUDA graph and replayed after the lengths change; and the
``CompiledServingEngine`` on the card against itself on the CPU (tokens,
per-round counters, one captured graph, K2 calls as planned).  Needs a
card; skips without one."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    flash_attention_ref,
    flash_attention_splitkv_ref,
)
from repro_torch.models.layers import AxisCtx  # noqa: E402
from repro_torch.runtime.serve import CompiledServingEngine  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LENGTHS = (1, 37, 64, 65, 500, 512, 1023, 1024)  # horizon 1024
NEW_LENGTHS = (2, 1024, 63, 1, 700, 129, 64, 999)
COUNTERS = ("admitted", "completed", "active", "queued", "prefill_tokens",
            "decode_tokens", "h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
            "critical_h2d_bytes", "prefetch_hits", "demand_misses",
            "peak_device_bytes")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, dtype, kv=16, seed=0, d=128):
    g = torch.Generator().manual_seed(seed)
    b, h = len(LENGTHS), 16
    return [torch.randn(s, generator=g).to(dev, getattr(torch, dtype))
            for s in ((b, 1, h, d), (b, 1024, kv, d), (b, 1024, kv, d))]


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("kv,d", [(16, 128), (8, 128), (2, 128),
                                  (16, 144)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_lens_decode_matches_plain_on_card(cuda_device, dtype, kv, d):
    """One length a row, read from the card, over the horizon plan: the
    kernel equals the plain version and the same splits merged in plain
    PyTorch, with most splits of the short rows empty."""
    q, k, v = _qkv(cuda_device, dtype, kv, d=d)
    lens = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda_device)
    before = fa.launches
    got, lse = fa.flash_attention_cuda(q, k, v, causal=False, kv_lens=lens,
                                       return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want, want_lse = flash_attention_ref(q, k, v, causal=False, kv_lens=lens,
                                         return_lse=True)
    err = _err(got, want)
    assert math.isfinite(err) and err <= TOL[dtype], err
    assert (lse - want_lse).abs().max().item() <= 1e-4
    plan = fa.plan_forward(len(LENGTHS), 1, 1024, 16, q.dtype, causal=False)
    split = flash_attention_splitkv_ref(
        q, k, v, splits=plan.splits, split_lo=plan.split_lo,
        split_rows=plan.split_rows, causal=False, kv_lens=lens)
    assert _err(got, split) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_lens_decode_replays_in_a_graph_after_the_lengths_change(
        cuda_device, dtype):
    """Captured once, the call records into the graph (``captured``, not
    ``launches``); replayed after the lengths in its static buffer change,
    it matches the plain version at the new lengths."""
    q, k, v = _qkv(cuda_device, dtype, seed=1)
    lens = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up
        fa.flash_attention_cuda(q, k, v, causal=False, kv_lens=lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launched, captured = fa.launches, fa.captured
    with torch.cuda.graph(graph):
        out = fa.flash_attention_cuda(q, k, v, causal=False, kv_lens=lens)
    assert (fa.launches, fa.captured) == (launched, captured + 1)
    for lengths in (NEW_LENGTHS, LENGTHS):
        lens.copy_(torch.tensor(lengths, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=False, kv_lens=lens)
        assert _err(out, want) <= TOL[dtype], lengths


@pytest.mark.gpu
@pytest.mark.parametrize("page_tokens", [None, 8])
@pytest.mark.parametrize("arch", ["gpt2-paper-1b", "qwen3-0.6b"])
def test_compiled_engine_on_card_matches_cpu(cuda_device, arch, page_tokens):
    """The compiled engine on the card: the CPU's tokens and per-round
    counters, one graph for its padded shape, and K2 calls (eager
    launches plus replays times the graph's calls) as the plan implies."""
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32",
                                               compute_dtype="float32")
    params = model_class(cfg)(cfg, AxisCtx()).init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (9, 9, 5)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = CompiledServingEngine(
            model_class(cfg), cfg, device=dev, device_memory_bytes=1_200_000,
            host_memory_bytes=8_000_000, max_seq_len=24,
            page_tokens=page_tokens, init_params=params)
        for p in prompts:
            eng.submit(p, 5)
        fa.launches = 0
        rounds = eng.run()
        eng.check_invariants()
        out[dev] = ([eng.result(i) for i in range(len(prompts))],
                    [{f: getattr(m, f) for f in COUNTERS} for m in rounds])
    assert out["cuda"] == out["cpu"]
    graph = eng.decode_graph
    assert eng.decode_compile_count == 1 and graph is not None
    assert graph.k2_calls == cfg.num_layers
    planned = cfg.num_layers * sum(m.prefill_cohorts + bool(m.decode_tokens)
                                   for m in rounds)
    assert fa.launches + graph.replays * graph.k2_calls == planned
    assert len(graph.device_ms) == graph.replays > 0


@pytest.mark.gpu
def test_padded_growth_recaptures_and_releases_on_card(cuda_device):
    """One admission a round crosses 2 -> 4 -> 8 slots: one graph is
    captured per padded shape, the outgrown ones are released, the slot
    rows survive each growth, and the tokens are the CPU's."""
    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    params = model_class(cfg)(cfg, AxisCtx()).init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=8) for _ in range(5)]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = CompiledServingEngine(
            model_class(cfg), cfg, device=dev, device_memory_bytes=1_300_000,
            host_memory_bytes=8_000_000, max_seq_len=24, init_params=params)
        shapes, graphs = [], []
        for p in prompts:
            eng.submit(p, 8)
            eng.step_round()
            shapes.append(eng.padded_slots)
            graphs.append(eng.decode_graph)
        eng.run()
        eng.check_invariants()
        out[dev] = ([eng.result(i) for i in range(len(prompts))], shapes,
                    eng.decode_compile_count)
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][1:] == ([2, 2, 4, 4, 8], 3)
    # the 2- and 4-slot graphs were released when the slots grew
    assert graphs[1].graph is None and graphs[3].graph is None
    assert eng.decode_graph.graph is not None
