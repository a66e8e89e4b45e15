"""The transfer timeline on the card against the CPU (same weights, same
batches and requests, the same fixed-bandwidth lanes): every
``StepTimeline`` of every training step and serving round identical —
the simulated clock sees only bytes, moments and durations — with
bandwidth-aware prefetch on and off, and every counter identical.  Needs
a card; skips without one."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.core.engine import PatrickStarEngine  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.core.timeline import TransferTimeline  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.models.layers import AxisCtx  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _lanes():
    return TransferTimeline(h2d_bandwidth=1e8, d2h_bandwidth=1e8)


@pytest.mark.gpu
@pytest.mark.parametrize("aware", [True, False], ids=["aware", "fixed"])
def test_card_train_timeline_matches_cpu(aware):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gpt2-paper-1b", smoke=True).replace(num_layers=4,
                                                          **FP32)
    params = model_class(cfg)(cfg, AxisCtx()).init_params(
        torch.Generator().manual_seed(0))
    nxt = make_batch_fn(cfg, 4, 64)
    batches = [nxt() for _ in range(3)]
    runs = []
    for device in ("cpu", "cuda"):
        eng = PatrickStarEngine(model_class(cfg), cfg, device=device,
                                device_memory_bytes=4_000_000,
                                timeline=_lanes(), init_params=params,
                                bandwidth_aware_prefetch=aware)
        runs.append([eng.step(b) for b in batches])
        eng.pool.check_invariants()
    for a, b in zip(*runs):
        assert dataclasses.asdict(b.timeline) == dataclasses.asdict(a.timeline)
        assert (b.h2d_bytes, b.d2h_bytes, b.hidden_h2d_bytes,
                b.prefetch_hits) == (a.h2d_bytes, a.d2h_bytes,
                                     a.hidden_h2d_bytes, a.prefetch_hits)
        assert abs(a.loss - b.loss) <= 1e-4 * abs(a.loss)
    assert sum(m.timeline.stall_s for m in runs[1]) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("manage_kv", [True, False],
                         ids=["managed", "unmanaged"])
def test_card_serving_timeline_matches_cpu(manage_kv):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-0.6b", smoke=True).replace(num_layers=3, **FP32)
    params = model_class(cfg)(cfg, AxisCtx()).init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (12, 12, 10)]
    runs = []
    for device in ("cpu", "cuda"):
        eng = ServingEngine(model_class(cfg), cfg, device=device,
                            device_memory_bytes=1_100_000, max_seq_len=24,
                            manage_kv=manage_kv, timeline=_lanes(),
                            init_params=params)
        for p in prompts:
            eng.submit(p, 5)
        rounds = eng.run()
        eng.check_invariants()
        runs.append(([eng.result(i) for i in range(len(prompts))], rounds))
    (cpu_toks, cpu_rounds), (gpu_toks, gpu_rounds) = runs
    assert gpu_toks == cpu_toks
    for a, b in zip(cpu_rounds, gpu_rounds, strict=True):
        assert dataclasses.asdict(b.timeline) == dataclasses.asdict(a.timeline)
        assert (b.h2d_bytes, b.d2h_bytes, b.peak_device_bytes) == \
            (a.h2d_bytes, a.d2h_bytes, a.peak_device_bytes)
