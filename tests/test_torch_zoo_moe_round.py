"""mixtral-8x7b's compiled serving round against the eager engine on the
CPU (the twin of ``tests/test_compiled_serving.py``'s MoE case; split out
of ``tests/test_torch_zoo.py``, see ``tests/test_torch_zoo_moe.py``): the
eager engine serves MoE one sequence a call, the compiled round routes
each slot on its own; routing the slots pooled instead drops tokens and
changes them."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core.serving import ServingEngine as RefServing  # noqa: E402
from repro.models.layers import AxisCtx  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.runtime.serve import CompiledServingEngine  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _burst(cfg, n=6, plen=8, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (n, plen))


_NEW_TOKENS = [8, 3, 8, 5, 8, 8]


def _serve_all(cls, cfg, params, prompts, **kw):
    eng = cls(model_class(cfg), cfg, device="cpu", init_params=params,
              device_memory_bytes=2_800_000, host_memory_bytes=24_000_000,
              max_seq_len=24, **kw)
    rids = [eng.submit(p, n) for p, n in zip(prompts, _NEW_TOKENS)]
    for m in eng.run():
        assert m.peak_device_bytes <= eng.device_capacity
    eng.check_invariants()
    return eng, [eng.result(r) for r in rids]


def _moe_case(capacity_factor=None):
    jcfg = jax_config("mixtral-8x7b", smoke=True).replace(**FP32)
    cfg = get_config("mixtral-8x7b", smoke=True).replace(**FP32)
    if capacity_factor is not None:
        jcfg = jcfg.replace(capacity_factor=capacity_factor)
        cfg = cfg.replace(capacity_factor=capacity_factor)
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    return jcfg, cfg, params


def test_compiled_round_matches_eager_moe():
    """The twin of ``test_compiled_serving.py``'s MoE case: staggered
    lifetimes, 6 sequences in 8 padded slots, a budget under which both
    engines spill; the eager engine serves MoE one sequence a call, and
    its tokens are the reference eager engine's."""
    jcfg, cfg, params = _moe_case()
    prompts = _burst(cfg)
    eager, out_e = _serve_all(ServingEngine, cfg, params_from_jax(params),
                              prompts)
    comp, out_c = _serve_all(CompiledServingEngine, cfg,
                             params_from_jax(params), prompts)
    assert eager._prefill_batchable() is False
    assert comp._prefill_batchable() is True
    assert out_c == out_e
    assert eager.pool.stats.d2h_bytes > 0 and comp.pool.stats.d2h_bytes > 0
    ref = RefServing(jax_model_class(jcfg), jcfg, init_params=params,
                     device_memory_bytes=2_800_000,
                     host_memory_bytes=24_000_000, max_seq_len=24)
    rids = [ref.submit(p, n) for p, n in zip(prompts, _NEW_TOKENS)]
    ref.run()
    assert [ref.result(r) for r in rids] == out_e


def test_pooled_routing_in_the_compiled_round_drops_tokens(monkeypatch):
    """Why the round routes per slot: at a capacity factor of 0.5 a slot's
    own decode capacity (4) never drops its token, while 8 slots pooled
    share a capacity of 4 an expert for 16 assignments and drop some.
    Per-slot routing keeps the eager engine's tokens; pooled routing (the
    round's context patched back to the training one) changes them."""
    from repro_torch.models import moe

    jcfg, cfg, params = _moe_case(capacity_factor=0.5)
    prompts = _burst(cfg)
    _, out_e = _serve_all(ServingEngine, cfg, params_from_jax(params),
                          prompts)
    _, out_c = _serve_all(CompiledServingEngine, cfg,
                          params_from_jax(params), prompts)
    assert out_c == out_e
    dropped = []
    real = moe.dispatch_indices

    def spy(idx, e, c):
        out = real(idx, e, c)
        dropped.append(int((~out[1]).sum()))
        return out

    monkeypatch.setattr(moe, "dispatch_indices", spy)
    monkeypatch.setattr(ChunkedRuntime, "_row_ctx", lambda self: self.ctx)
    _, out_p = _serve_all(CompiledServingEngine, cfg,
                          params_from_jax(params), prompts)
    assert sum(dropped) > 0
    assert out_p != out_e
