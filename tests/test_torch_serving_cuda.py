"""The port's ``ServingEngine`` on the card against itself on the CPU
(same weights, same requests): greedy tokens and every per-round memory
counter identical, and the flash-attention kernel launched exactly as
often as the plan implies.  Needs a card; skips without one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.layers import AxisCtx  # noqa: E402

COUNTERS = ("admitted", "completed", "active", "queued", "prefill_tokens",
            "decode_tokens", "h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
            "critical_h2d_bytes", "prefetch_hits", "demand_misses",
            "peak_device_bytes", "prefill_cohorts", "decode_batches")


def _serve(cfg, params, prompts, device, page_tokens):
    eng = ServingEngine(model_class(cfg), cfg, device=device,
                        device_memory_bytes=1_100_000, max_seq_len=24,
                        page_tokens=page_tokens, init_params=params)
    for p in prompts:
        eng.submit(p, 5)
    rounds = eng.run()
    eng.check_invariants()
    return [eng.result(i) for i in range(len(prompts))], rounds


@pytest.mark.gpu
@pytest.mark.parametrize("page_tokens", [None, 4])
@pytest.mark.parametrize("arch", ["gpt2-paper-1b", "qwen3-0.6b"])
def test_card_serving_matches_cpu(arch, page_tokens):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True).replace(
        num_layers=3, param_dtype="float32", compute_dtype="float32")
    params = model_class(cfg)(cfg, AxisCtx()).init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (12, 12, 10, 10)]
    cpu_toks, cpu_rounds = _serve(cfg, params, prompts, "cpu", page_tokens)
    fa.launches = 0
    gpu_toks, gpu_rounds = _serve(cfg, params, prompts, "cuda", page_tokens)
    launches = fa.launches
    assert gpu_toks == cpu_toks
    assert [{f: getattr(m, f) for f in COUNTERS} for m in gpu_rounds] == \
        [{f: getattr(m, f) for f in COUNTERS} for m in cpu_rounds]
    assert sum(m.h2d_bytes for m in gpu_rounds) > 0
    assert launches == cfg.num_layers * sum(
        m.prefill_cohorts + m.decode_batches for m in gpu_rounds)
