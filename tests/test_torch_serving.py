"""``ServingEngine`` in both packages on the same weights (made with
numpy from a seed, brought over with ``params_from_jax``): under a device budget tight
enough to spill KV, unpaged and paged, the greedy tokens and every
per-round memory counter must be identical."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core.serving import ServingEngine as RefEngine  # noqa: E402
from repro.models.layers import AxisCtx  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402

COUNTERS = ("admitted", "completed", "active", "queued", "prefill_tokens",
            "decode_tokens", "h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
            "critical_h2d_bytes", "prefetch_hits", "demand_misses",
            "peak_device_bytes")


def _rounds(engine, kv_d2h):
    out = []
    while True:
        m = engine.step_round()
        if m is None:
            return out
        if engine.kv_mgr is not None:
            kv_d2h[0] = max(kv_d2h[0], engine.kv_mgr.stats.d2h_bytes)
        out.append(m)


# page_tokens=4: every prompt spans >1 page (the reference's single-page
# paged load reshapes one page to the whole horizon and fails)
@pytest.mark.parametrize("page_tokens", [None, 4])
@pytest.mark.parametrize("arch", ["gpt2-paper-1b", "qwen3-0.6b"])
def test_tokens_and_round_counters_match_reference(arch, page_tokens):
    jcfg = jax_config(arch, smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    kw = dict(device_memory_bytes=1_200_000, host_memory_bytes=8_000_000,
              max_seq_len=16, page_tokens=page_tokens)
    ref = RefEngine(jax_model_class(jcfg), jcfg, init_params=params, **kw)
    port = ServingEngine(model_class(cfg), cfg, device="cpu",
                         init_params=params_from_jax(params), **kw)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (9, 9, 5)]
    for p in prompts:
        assert ref.submit(p, 4) == port.submit(p, 4)
    ref_kv, port_kv = [0], [0]
    ref_rounds = _rounds(ref, ref_kv)
    port_rounds = _rounds(port, port_kv)
    for rid in range(len(prompts)):
        assert port.result(rid) == ref.result(rid)
    assert len(port_rounds) == len(ref_rounds)
    for a, b in zip(ref_rounds, port_rounds):
        assert {f: getattr(b, f) for f in COUNTERS} == \
            {f: getattr(a, f) for f in COUNTERS}, a.round_index
    assert port_kv[0] == ref_kv[0] > 0  # the budget really spilled KV
    assert sum(m.prefetch_hits for m in port_rounds) > 0
    port.check_invariants()


def test_entry_point_runs_on_cuda_or_raises():
    cfg = get_config("gpt2-paper-1b", smoke=True)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model_class(cfg), cfg, device_memory_bytes=1 << 30)
