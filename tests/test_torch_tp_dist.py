"""The runtime's serving steps at tp > 1 on the CPU: qwen2.5 at tp = 4
through the "dist" cache against the reference's, and the twin of
``tests/test_serve.py`` at dp 2 x tp 2 (``tests/_torch_tp.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

import _torch_tp as H  # noqa: E402


def test_qwen25_tp4_dist_cache_serving_matches_reference():
    """qwen2.5 smoke (2 kv heads) at tp = 4, so the "dist" cache plan (2
    kv-head groups x 2 strided sequence chunks), from the reference's
    tp = 4 ``init_state`` stores taken as they are: the prefill logits,
    each rank's cache and 4 greedy decode steps through the grown "dist"
    cache identical to the reference's."""
    jrt, rt = H.runtimes("qwen2.5-3b", 1, 4)
    (ps, _), (tps, _) = H.start(jrt, rt)
    from repro_torch.models.layers import decode_cache_plan

    assert decode_cache_plan(rt.cfg, 4) == ("dist", 1, 2)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, rt.cfg.vocab_size, (4, 16))
    H.check_serving(H.serve_both(jrt, rt, ps, tps, {"tokens": tok},
                               {"tokens": jnp.asarray(tok, jnp.int32)}, 16))


def test_prefill_logits_match_greedy_decode_dp2_tp2():
    """The twin of ``tests/test_serve.py`` at dp 2 x tp 2 (qwen3 smoke):
    the prefill logits' argmax equals the next token of a decode that
    replays the prompt one token at a time from empty caches, and two
    decodes of one input agree."""
    cfg = get_config("qwen3-0.6b", smoke=True).replace(**H.FP32)
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(2, 2, device="cpu"),
                        RuntimeOptions())
    ps, _ = driver.init_state(rt, 0)
    b, s = 4, 16
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s))
    pre, _ = driver.build_prefill_step(rt, InputShape("serve", s, b,
                                                      "decode"))
    logits, _ = pre(ps, {"tokens": tok})
    assert tuple(logits.shape) == (b, 1, cfg.vocab_size)
    greedy = logits[:, 0].argmax(-1)
    dshape = InputShape("serve", s + 1, b, "decode")
    dec, _ = driver.build_decode_step(rt, dshape)
    c = driver.init_caches(rt, dshape)
    assert tuple(c["layers"]["k"].shape) == (2, cfg.num_layers, b, s + 1,
                                             1, cfg.head_dim)
    nxt = None
    for i in range(s):
        nxt, c = dec(ps, c, tok[:, i:i + 1], i)
    assert torch.equal(nxt, greedy)
    again, _ = dec(ps, driver.init_caches(rt, dshape), tok[:, :1], 0)
    first, _ = dec(ps, driver.init_caches(rt, dshape), tok[:, :1], 0)
    assert torch.equal(again, first)
