#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. environment — torch and CUDA versions, the card's capability (9.0
   required) and ``nvidia-smi``'s name and power limit;
2. build — the hand-written CUDA kernels, compiled from the checkout's
   sources with ``nvcc`` into ``build/kernels/`` (one ``nvcc`` per
   source, all started together);
3. kernel — K2 (flash-attention forward) against its plain PyTorch
   version at the slice's prefill and decode shapes, bf16 (tolerance
   2e-2) and fp32 (1e-4), GQA and D=32; its time beside the plain
   version's, ``scaled_dot_product_attention``'s (a yardstick the port
   never calls) and the least time the card could take;
4. parity — gpt2-paper-1b at full width, 2 layers, fp32, the same
   weights served on the CPU (plain attention) and on the card (the
   kernel) under a device budget that pages chunks: greedy tokens and
   every per-round memory counter must be identical;
5. slice — gpt2-paper-1b at full depth and width, bf16 compute, under a
   2 GiB device budget (the 4.28 GB fp32 param stream cannot fit, so
   params and KV page through the pool): 4 requests (prompts 512, 512,
   500, 500) for 16 new tokens each.  Launch counts are zeroed just
   before ``run()`` and read just after; the kernel must have run exactly
   as often as the plan implies, and ``torch.cuda.max_memory_allocated``
   must stay within the budget plus the stem plus 1 GiB of activations;
6. kernels — one line listing every ported kernel with its TPU
   counterpart, launches, error and times.

Then the card's name and power limit on a line of their own, and last the
``{"ok": true, "device": ...}`` line.  Any failed check raises, and the
script exits non-zero without that line; so it does when no card is
present or when the script stands alone, without the repository beside it.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (the roofline the bound is taken against)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
GIB = 1 << 30


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events, after
    a warm-up)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# --------------------------------------------------------------- kernel phase
def attention_bound(case) -> tuple[float, str]:
    """Least time for the work on this run's data: each input byte the
    masks let through read once, the output written once; 4*D flops per
    visible (query, key) pair per head.  Returns (ms, what bounds it)."""
    b, sq, sk, h, kv, d = case["shape"]
    item = 2 if case["dtype"] == "bfloat16" else 4
    kv_len = case.get("kv_len") or sk
    q_off = case.get("q_offset", 0)
    window = case.get("window")
    pairs = 0
    for i in range(sq):
        hi = min(kv_len, q_off + i + 1) if case["causal"] else kv_len
        lo = max(0, q_off + i - window + 1) if window else 0
        pairs += max(0, hi - lo)
    nbytes = item * (2 * b * sq * h * d + 2 * b * kv_len * kv * d)
    flops = 4 * b * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[case["dtype"]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNEL_CASES = [
    # the slice's prefill cohorts (B=2, S=512 and ragged 500, H=16, D=128)
    dict(name="prefill_512", shape=(2, 512, 512, 16, 16, 128), causal=True),
    dict(name="prefill_500", shape=(2, 500, 500, 16, 16, 128), causal=True),
    # the slice's decode batches: one query over a 1024-slot cache
    dict(name="decode_kv1", shape=(4, 1, 1024, 16, 16, 128), causal=True,
         q_offset=0, kv_len=1),
    dict(name="decode_kv37", shape=(4, 1, 1024, 16, 16, 128), causal=True,
         q_offset=36, kv_len=37),
    dict(name="decode_kv1024", shape=(4, 1, 1024, 16, 16, 128), causal=True,
         q_offset=1023, kv_len=1024),
    # GQA and the small head dim
    dict(name="prefill_gqa", shape=(2, 512, 512, 16, 8, 128), causal=True),
    dict(name="prefill_d32", shape=(2, 256, 256, 16, 16, 32), causal=True),
]


def kernel_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for base in KERNEL_CASES:
        for dtype in ("bfloat16", "float32"):
            case = dict(base, dtype=dtype)
            b, sq, sk, h, kv, d = case["shape"]
            dt = getattr(torch, dtype)
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt)
            k = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(dt)
            v = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(dt)
            kw = {key: case[key] for key in ("causal", "q_offset", "kv_len")
                  if key in case}
            got = fa.flash_attention_cuda(q, k, v, **kw)
            want = fa.plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not (math.isfinite(err) and err <= TOL[dtype]):
                raise AssertionError(f"K2 {case['name']} {dtype}: max abs "
                                     f"error {err} > {TOL[dtype]}")
            ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
            plain_ms = time_ms(lambda: fa.plain(q, k, v, **kw))
            # the yardstick: one library call on the same inputs, [B,H,S,D]
            kvl = kw.get("kv_len", sk)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :kvl],
                                                       v[:, :kvl]))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=sq > 1, enable_gqa=kv != h)
            library_ms = time_ms(lib)
            bound_ms, bound_by = attention_bound(case)
            row = dict(case=case["name"], dtype=dtype, shape=case["shape"],
                       max_abs_err=err, tol=TOL[dtype], ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            emit({"phase": "kernel", "kernel": "flash_attention_fwd", **row})
            results[(case["name"], dtype)] = row
            del q, k, v, got, want
    return results


# --------------------------------------------------------------- serving
def serve(cfg, params, prompts, new_tokens, *, device, **kw):
    """Serve ``prompts`` on ``device``; returns (engine, round metrics)."""
    from repro_torch.configs import model_class
    from repro_torch.core.serving import ServingEngine

    eng = ServingEngine(model_class(cfg), cfg, device=device,
                        init_params=params, **kw)
    for p in prompts:
        eng.submit(p, new_tokens)
    return eng, eng.run()


COUNTERS = ("h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
            "critical_h2d_bytes", "prefetch_hits", "demand_misses",
            "peak_device_bytes")


def parity_phase() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config, model_class
    from repro_torch.core.serving import ServingEngine
    from repro_torch.models.layers import AxisCtx

    cfg = get_config("gpt2-paper-1b").replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    params = model_class(cfg)(cfg, AxisCtx()).init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=128) for _ in range(2)]
    horizon = 128 + 8
    # half of this config's param stream is below one layer's chunks
    # (2 of its 3 chunks), so the budget is the engine's floor: one
    # layer's param chunks plus two kv chunks — the stream must page
    probe = ServingEngine(model_class(cfg), cfg, device="cpu",
                          device_memory_bytes=1 << 40,
                          max_seq_len=horizon, init_params=params)
    stream_bytes = probe._param_stream_bytes
    budget = max(stream_bytes // 2, probe.device_floor_bytes)
    del probe
    kw = dict(device_memory_bytes=budget, max_seq_len=horizon)
    t0 = time.perf_counter()
    cpu, cpu_rounds = serve(cfg, params, prompts, 8, device="cpu", **kw)
    t1 = time.perf_counter()
    gpu, gpu_rounds = serve(cfg, params, prompts, 8, device="cuda", **kw)
    t2 = time.perf_counter()
    gpu.check_invariants()
    toks_cpu = [cpu.result(i) for i in range(len(prompts))]
    toks_gpu = [gpu.result(i) for i in range(len(prompts))]
    if toks_cpu != toks_gpu:
        raise AssertionError(f"parity: tokens differ cpu={toks_cpu} "
                             f"cuda={toks_gpu}")
    per_round = []
    for a, b in zip(cpu_rounds, gpu_rounds, strict=True):
        ca = {f: getattr(a, f) for f in COUNTERS}
        cb = {f: getattr(b, f) for f in COUNTERS}
        if ca != cb:
            raise AssertionError(f"parity: round {a.round_index} counters "
                                 f"differ cpu={ca} cuda={cb}")
        per_round.append(ca)
    h2d = sum(r["h2d_bytes"] for r in per_round)
    if h2d <= 0:
        raise AssertionError("parity: the budget did not page any chunk")
    out = dict(phase="parity", config="gpt2-paper-1b", layers=2,
               dtype="float32", prompts=[128, 128], new_tokens=8,
               param_stream_bytes=stream_bytes, device_budget_bytes=budget,
               tokens=toks_gpu, rounds=len(per_round), h2d_bytes=h2d,
               d2h_bytes=sum(r["d2h_bytes"] for r in per_round),
               prefetch_hits=sum(r["prefetch_hits"] for r in per_round),
               cpu_s=t1 - t0, cuda_s=t2 - t1, tokens_identical=True,
               counters_identical=True)
    emit(out)
    del cpu, gpu, params
    return out


def slice_phase() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config, model_class
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import AxisCtx

    cfg = get_config("gpt2-paper-1b")  # 20 layers, bf16 compute
    budget = 2 * GIB
    t0 = time.perf_counter()
    params = model_class(cfg)(cfg, AxisCtx()).init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    lens = (512, 512, 500, 500)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from repro_torch.core.serving import ServingEngine

    eng = ServingEngine(model_class(cfg), cfg, device="cuda",
                        device_memory_bytes=budget, max_seq_len=1024,
                        policy="opt", prefetch=True, init_params=params)
    del params
    for p in prompts:
        eng.submit(p, 16)
    t1 = time.perf_counter()
    fa.launches = 0
    rounds = eng.run()
    launches = fa.launches
    torch.cuda.synchronize()
    eng.check_invariants()
    peak = torch.cuda.max_memory_allocated()
    planned = cfg.num_layers * sum(m.prefill_cohorts + m.decode_batches
                                   for m in rounds)
    if launches != planned:
        raise AssertionError(f"slice: K2 launched {launches} times, the "
                             f"plan implies {planned}")
    h2d = sum(m.h2d_bytes for m in rounds)
    d2h = sum(m.d2h_bytes for m in rounds)
    if h2d <= 0 or d2h <= 0:
        raise AssertionError(f"slice: no paging (h2d={h2d}, d2h={d2h})")
    limit = budget + eng.stem_bytes + GIB
    if peak > limit:
        raise AssertionError(f"slice: max_memory_allocated {peak} > budget "
                             f"+ stem + 1 GiB = {limit}")
    for rid in range(len(prompts)):
        toks = eng.result(rid)
        if len(toks) != 16 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"slice: request {rid} gave {toks}")
    pre = [m for m in rounds if m.prefill_tokens]
    dec = [m for m in rounds if m.decode_tokens and not m.prefill_tokens]
    pre_tok = sum(m.prefill_tokens for m in pre)
    dec_tok = sum(m.decode_tokens for m in dec)
    out = dict(
        phase="slice", config="gpt2-paper-1b", layers=cfg.num_layers,
        d_model=cfg.d_model, compute_dtype=cfg.compute_dtype,
        device_budget_bytes=budget,
        param_stream_bytes=eng._param_stream_bytes,
        param_chunk_bytes=eng.params_mgr.chunk_bytes,
        kv_chunk_bytes=eng.kv_chunk_bytes, stem_bytes=eng.stem_bytes,
        prompts=list(lens), new_tokens=16, rounds=len(rounds),
        setup_s=t1 - t0,
        prefill_tokens=pre_tok, prefill_s=sum(m.wall_s for m in pre),
        prefill_tok_per_s=pre_tok / sum(m.wall_s for m in pre),
        decode_tokens=dec_tok, decode_s=sum(m.wall_s for m in dec),
        decode_tok_per_s=dec_tok / sum(m.wall_s for m in dec),
        round_wall_s=[m.wall_s for m in rounds],
        round_h2d_bytes=[m.h2d_bytes for m in rounds],
        round_d2h_bytes=[m.d2h_bytes for m in rounds],
        h2d_bytes=h2d, d2h_bytes=d2h,
        hidden_h2d_bytes=sum(m.hidden_h2d_bytes for m in rounds),
        prefetch_hits=sum(m.prefetch_hits for m in rounds),
        demand_misses=sum(m.demand_misses for m in rounds),
        k2_launches=launches, k2_planned=planned,
        max_memory_allocated=peak, memory_limit=limit,
        tokens=[eng.result(i) for i in range(len(prompts))])
    emit(out)
    del eng
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch is not beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False;"
                         " this script needs an NVIDIA card")
    # full fp32 products: the parity phase compares against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    emit(dict(phase="environment", python=sys.version.split()[0],
              torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0), capability=list(cap),
              nvidia_smi=card))
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke.py: needs a Hopper card (capability "
                         f"9.0), found {cap}")

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    libs = build.build_all([fa.SOURCE])
    fa.load()
    ptxas = [ln.strip() for ln in
             (libs[0].parent / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", sources=[fa.SOURCE], seconds=time.perf_counter()
              - t0, library=str(libs[0].relative_to(ROOT)), ptxas=ptxas))

    kern = kernel_phase()
    gc.collect()
    parity_phase()
    gc.collect()
    sl = slice_phase()

    main_case = kern[("prefill_512", "bfloat16")]
    decode = kern[("decode_kv1024", "bfloat16")]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": fa.REPLACES, "launches": sl["k2_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": "prefill B=2 S=512 H=16 D=128 bf16 causal",
        "decode_ms": decode["ms"], "decode_plain_ms": decode["plain_ms"],
        "decode_bound_ms": decode["bound_ms"],
        "decode_library_ms": decode["library_ms"],
        "card": card}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
