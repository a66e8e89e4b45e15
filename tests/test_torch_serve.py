"""The runtime's serving steps (``repro_torch.runtime.driver``'s
``build_prefill_step``, ``build_decode_step``, ``init_caches`` and
``grow_caches``) against the reference's on the same stores, at tp=1 on
the CPU: prefill + greedy decode equals the argmax of the prefill logits,
decode is deterministic, and decode continues from grown prefill caches.
Twins of ``tests/test_serve.py`` on a ``(1, 1)`` mesh with qwen3-0.6b
smoke (the reference's tp=2 mesh and qwen2.5-3b are not ported)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.configs.base import InputShape as JaxShape  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jax_mesh  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro.runtime.step import RuntimeOptions as JaxOptions  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import stores_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _both(**kw):
    """Both runtimes on qwen3-0.6b smoke and one set of param stores: the
    reference's ``init_state``, converted."""
    jcfg = jax_config("qwen3-0.6b", smoke=True).replace(**kw)
    cfg = get_config("qwen3-0.6b", smoke=True).replace(**kw)
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(1, 1),
                     JaxOptions())
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(1, 1, device="cpu"), RuntimeOptions())
    jps, jos = jax_driver.init_state(jrt, jax.random.key(0))
    ps, _ = stores_from_jax(jax.device_get(jps), jax.device_get(jos))
    return jrt, jps, rt, ps, cfg


def _np(t):
    return t.detach().float().numpy()


def test_prefill_logits_match_greedy_decode():
    jrt, jps, rt, ps, cfg = _both(**FP32)
    b, s = 4, 16
    tok = np.asarray(jax.random.randint(jax.random.key(2), (b, s), 0,
                                        cfg.vocab_size))
    shape = InputShape("serve", s, b, "decode")
    pre, _ = driver.build_prefill_step(rt, shape)
    logits, caches = pre(ps, {"tokens": tok})
    assert tuple(logits.shape) == (b, 1, cfg.vocab_size)
    greedy = _np(logits[:, 0]).argmax(-1)

    jpre, _ = jax_driver.build_prefill_step(jrt, JaxShape("serve", s, b,
                                                          "decode"))
    jlogits, jcaches = jpre(jps, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(caches["layers"][name]),
                                   np.asarray(jcaches["layers"][name]),
                                   rtol=1e-4, atol=1e-4)

    # decode replays the same tokens one by one from empty caches
    dshape = InputShape("serve", s + 1, b, "decode")
    dec, _ = driver.build_decode_step(rt, dshape)
    c = driver.init_caches(rt, dshape)
    assert tuple(c["layers"]["k"].shape) == (1, cfg.num_layers, b, s + 1,
                                             cfg.n_kv_heads, cfg.head_dim)
    nxt = None
    for i in range(s):
        nxt, c = dec(ps, c, tok[:, i:i + 1], i)
    np.testing.assert_array_equal(nxt.numpy(), greedy)


def test_decode_is_deterministic_and_matches_reference():
    jrt, jps, rt, ps, cfg = _both()  # the config's own dtypes (bf16)
    shape = InputShape("serve", 8, 4, "decode")
    dec, _ = driver.build_decode_step(rt, shape)
    tok = np.ones((4, 1), np.int32)
    n1, _ = dec(ps, driver.init_caches(rt, shape), tok, 0)
    n2, _ = dec(ps, driver.init_caches(rt, shape), tok, 0)
    np.testing.assert_array_equal(n1.numpy(), n2.numpy())
    jshape = JaxShape("serve", 8, 4, "decode")
    jdec, _ = jax_driver.build_decode_step(jrt, jshape)
    jn, _ = jdec(jps, jax_driver.init_caches(jrt, jshape), jnp.asarray(tok),
                 jnp.int32(0))
    np.testing.assert_array_equal(n1.numpy(), np.asarray(jn))


def test_prefill_grow_then_decode_matches_fwd():
    """prefill -> grow_caches -> decode equals decode replayed from empty
    caches, and the reference's tokens."""
    jrt, jps, rt, ps, cfg = _both(**FP32)
    b, s, extra = 4, 12, 3
    tok = np.asarray(jax.random.randint(jax.random.key(5), (b, s + extra),
                                        0, cfg.vocab_size))
    pre, _ = driver.build_prefill_step(rt, InputShape("p", s, b, "decode"))
    logits, caches = pre(ps, {"tokens": tok[:, :s]})
    dshape = InputShape("d", s + extra, b, "decode")
    caches = driver.grow_caches(rt, caches, s, s + extra, dshape)
    assert tuple(caches["layers"]["k"].shape)[3] == s + extra
    dec, _ = driver.build_decode_step(rt, dshape)
    nxt = _np(logits[:, 0]).argmax(-1)
    c2 = driver.init_caches(rt, dshape)
    got = None
    for i in range(s):
        got, c2 = dec(ps, c2, tok[:, i:i + 1], i)
    np.testing.assert_array_equal(got.numpy(), nxt)
    ga, gb = caches, c2
    ours = []
    for i in range(extra):
        ta, ga = dec(ps, ga, tok[:, s + i:s + i + 1], s + i)
        tb, gb = dec(ps, gb, tok[:, s + i:s + i + 1], s + i)
        np.testing.assert_array_equal(ta.numpy(), tb.numpy())
        ours.append(ta.numpy())

    jpre, _ = jax_driver.build_prefill_step(jrt, JaxShape("p", s, b,
                                                          "decode"))
    _, jc = jpre(jps, {"tokens": jnp.asarray(tok[:, :s])})
    jshape = JaxShape("d", s + extra, b, "decode")
    jc = jax_driver.grow_caches(jrt, jc, s, s + extra, jshape)
    jdec, _ = jax_driver.build_decode_step(jrt, jshape)
    for i in range(extra):
        jt, jc = jdec(jps, jc, jnp.asarray(tok[:, s + i:s + i + 1]),
                      jnp.int32(s + i))
        np.testing.assert_array_equal(ours[i], np.asarray(jt))
    with pytest.raises(ValueError, match="cannot grow"):
        driver.grow_caches(rt, caches, s + extra, s,
                           InputShape("d", s, b, "decode"))
