"""Each ported layer function against its ``repro.models.layers`` twin on
the same numpy inputs (fp32 tolerance 1e-5: the same math summed in
another order), plus the mixed-dtype matmul, greedy ties, and the
attention prefill/decode blocks on the smoke configs of every ported
arch (gpt2-paper-1b and -4b, qwen3-0.6b, qwen2.5-3b, deepseek-7b)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = 1e-5
JCTX = JL.AxisCtx()
TCTX = TL.AxisCtx()


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_matmul_same_and_mixed_dtypes():
    x, w = _rand(0, 2, 3, 16), _rand(1, 16, 8)
    _close(TL.matmul(torch.from_numpy(x), torch.from_numpy(w)),
           JL.matmul(jnp.asarray(x), jnp.asarray(w)))
    # bf16 activation x fp32 chunk payload: JAX promotes to fp32 and
    # returns x.dtype; torch would refuse the mixed product
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = TL.matmul(xb, torch.from_numpy(w))
    want = JL.matmul(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, 2e-2)
    got = TL.matmul(xb, torch.from_numpy(w), torch.float32)
    want = JL.matmul(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                     jnp.float32)
    assert got.dtype == torch.float32
    _close(got, want)


def test_norms_and_activations():
    x, w, b = _rand(2, 3, 5, 32), _rand(3, 32), _rand(4, 32)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    jx, jw, jb = map(jnp.asarray, (x, w, b))
    _close(TL.rms_norm(tx, tw), JL.rms_norm(jx, jw))
    _close(TL.layer_norm(tx, tw, tb), JL.layer_norm(jx, jw, jb))
    for name, fn in TL.ACTIVATIONS.items():
        _close(fn(tx), JL.ACTIVATIONS[name](jx))


def test_rope():
    x = _rand(5, 2, 7, 4, 32)
    pos = np.arange(7)[None].repeat(2, 0) + 3
    _close(TL.rope_freqs(32, 500.0), JL.rope_freqs(32, 500.0))
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0))


@pytest.mark.parametrize("impl", ["naive", "scan", "auto"])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_attention_cores(impl, kv_heads):
    q, k, v = _rand(6, 2, 9, 4, 32), _rand(7, 2, 9, kv_heads, 32), \
        _rand(8, 2, 9, kv_heads, 32)
    kw = dict(causal=True, q_offset=2, kv_len=8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ctx_t = TL.AxisCtx(attn_impl=impl, attn_block=4)
    ctx_j = JL.AxisCtx(attn_impl=impl, attn_block=4)
    _close(TL.attention_core(tq, tk, tv, ctx_t, **kw),
           JL.attention_core(jq, jk, jv, ctx_j, **kw))


def test_naive_attention_rounds_probabilities_like_the_reference():
    q, k, v = (_rand(s, 1, 6, 2, 32) for s in (9, 10, 11))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    _close(TL.naive_attention(tq, tk, tv, causal=True),
           JL.naive_attention(jq, jk, jv, causal=True), 2e-2)


def test_embedding_head_and_greedy_ties():
    table = _rand(12, 20, 16)
    ids = np.array([[1, 5, 19], [0, 0, 7]])
    tt, jt = {"table": torch.from_numpy(table)}, {"table": jnp.asarray(table)}
    emb = TL.embed_lookup(tt, torch.from_numpy(ids), 20, TCTX)
    _close(emb, JL.embed_lookup(jt, jnp.asarray(ids), 20, JCTX))
    x = _rand(13, 2, 1, 16)
    _close(TL.lm_logits_local(tt, torch.from_numpy(x), TCTX),
           JL.lm_logits_local(jt, jnp.asarray(x), JCTX))
    # planted ties: the lowest id wins; ids past the vocab never do
    logits = np.zeros((3, 1, 24), np.float32)
    logits[0, 0, [3, 9, 17]] = 2.0
    logits[1, 0, [22, 23]] = 9.0  # padding rows past vocab=20
    logits[1, 0, [11, 4]] = 1.0
    logits[2, 0, :] = -1.0
    got = TL.greedy_token(torch.from_numpy(logits), 20, TCTX).tolist()
    want = np.asarray(JL.greedy_token(jnp.asarray(logits), 20, JCTX)).tolist()
    assert got == want == [3, 4, 0]


def _cfgs():
    return ["gpt2-paper-1b", "qwen3-0.6b", "gpt2-paper-4b", "qwen2.5-3b",
            "deepseek-7b"]


@functools.lru_cache(maxsize=None)
def _model_and_params(arch):
    """Both models on the reference's weights (built once per arch; the
    tests only read them)."""
    jcfg = jax_config(arch, smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    jparams = numpy_params(jm, 0)
    tm = model_class(cfg)(cfg, TCTX)
    return jcfg, cfg, jm, tm, jparams, params_from_jax(jparams)


def _jit(fn, *static):
    """The reference function compiled whole (one XLA compile instead of
    one per primitive in eager mode)."""
    return jax.jit(fn, static_argnums=static)


def _layer(tree, i, to_torch):
    if isinstance(tree, dict):
        return {k: _layer(v, i, to_torch) for k, v in tree.items()}
    return tree[i] if to_torch else jnp.asarray(tree[i])


@pytest.mark.parametrize("arch", _cfgs())
def test_attention_and_mlp_blocks(arch):
    jcfg, cfg, jm, tm, jp, tp = _model_and_params(arch)
    jl = _layer(jp["groups"]["layers"], 0, False)
    tl = _layer(tp["groups"]["layers"], 0, True)
    x = _rand(20, 2, 6, cfg.d_model)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    # init shapes match the reference's
    shapes = lambda t: {k: tuple(v.shape) for k, v in t.items()}  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    assert shapes(TL.init_attention(gen, cfg)) == shapes(jl["attn"])
    assert shapes(TL.init_mlp(gen, cfg)) == shapes(jl["mlp"])
    _close(TL.mlp_fwd(tl["mlp"], tx, cfg, TCTX),
           _jit(JL.mlp_fwd, 2, 3)(jl["mlp"], jx, jcfg, JCTX))
    pos = np.arange(6)[None].repeat(2, 0)
    for a, b in zip(TL._project_qkv(tl["attn"], tx, cfg, TCTX,
                                    torch.from_numpy(pos)),
                    _jit(JL._project_qkv, 2, 3)(jl["attn"], jx, jcfg, JCTX,
                                                jnp.asarray(pos))):
        _close(a, b)
    _close(TL.attention_fwd(tl["attn"], tx, cfg, TCTX),
           _jit(JL.attention_fwd, 2, 3)(jl["attn"], jx, jcfg, JCTX))
    ty, tcache = TL.attention_prefill(tl["attn"], tx, cfg, TCTX)
    jy, jcache = _jit(JL.attention_prefill, 2, 3)(jl["attn"], jx, jcfg,
                                                  JCTX)
    _close(ty, jy)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    assert TL.decode_cache_plan(cfg, 1) == JL.decode_cache_plan(jcfg, 1)
    # decode one token into a 10-slot cache holding the prefill at pos 6
    tz = TL.attention_init_cache(cfg, 2, 10, 1, torch.float32)
    jz = JL.attention_init_cache(jcfg, 2, 10, 1, jnp.float32)
    assert {k: tuple(v.shape) for k, v in tz.items()} == \
        {k: tuple(v.shape) for k, v in jz.items()}
    for key in ("k", "v"):
        tz[key][:, :6] = tcache[key]
        jz[key] = jz[key].at[:, :6].set(jcache[key])
    xd = _rand(21, 2, 1, cfg.d_model)
    ty, tc2 = TL.attention_decode(tl["attn"], torch.from_numpy(xd), tz, 6,
                                  cfg, TCTX)
    jy, jc2 = _jit(JL.attention_decode, 4, 5)(
        jl["attn"], jnp.asarray(xd), jz, jnp.int32(6), jcfg, JCTX)
    _close(ty, jy)
    for key in ("k", "v"):
        _close(tc2[key], jc2[key])
    assert not tz["k"][:, 6].any()  # the input cache is left untouched


@pytest.mark.parametrize("arch", _cfgs())
def test_model_prefill_decode_and_head(arch):
    """Whole model, both groups' layers in turn: embed -> prefill layers
    -> head logits, then one decode step per layer."""
    jcfg, cfg, jm, tm, jp, tp = _model_and_params(arch)
    ids = np.random.default_rng(22).integers(0, cfg.vocab_size, (2, 7))
    tg, jg = tm.groups()[0], jm.groups()[0]
    tx, _ = tm.embed(tp["stem"], {"tokens": torch.from_numpy(ids)})
    jx, _ = jm.embed(jp["stem"], {"tokens": jnp.asarray(ids)})
    jprefill, jdecode = _jit(jg.prefill, 3), _jit(jg.decode, 5)
    tcaches, jcaches = [], []
    for i in range(cfg.num_layers):
        tx, tc = tg.prefill(_layer(tp["groups"]["layers"], i, True), tx,
                            None, TCTX)
        jx, jc = jprefill(_layer(jp["groups"]["layers"], i, False), jx,
                          None, JCTX)
        _close(tx, jx)
        tcaches.append(tc)
        jcaches.append(jc)
    _close(tm.head_logits(tp["stem"], tx[:, -1:]),
           jm.head_logits(jp["stem"], jx[:, -1:]))
    # the full-sequence apply of the last layer agrees as well
    last = cfg.num_layers - 1
    ty, taux = tg.apply(_layer(tp["groups"]["layers"], last, True), tx,
                        None, TCTX)
    jy, jaux = _jit(jg.apply, 3)(_layer(jp["groups"]["layers"], last,
                                        False), jx, None, JCTX)
    _close(ty, jy)
    assert taux == float(jaux) == 0.0
    tok = np.array([[3], [5]])
    tx = tm.embed_decode(tp["stem"], torch.from_numpy(tok), 7, None)
    jx = jm.embed_decode(jp["stem"], jnp.asarray(tok), jnp.int32(7), None)
    for i in range(cfg.num_layers):
        tz = tg.init_cache(2, 9)
        jz = jg.init_cache(2, 9)
        for key in ("k", "v"):
            tz[key][:, :7] = tcaches[i][key]
            jz[key] = jz[key].at[:, :7].set(jcaches[i][key])
        tx, _ = tg.decode(_layer(tp["groups"]["layers"], i, True), tx, tz, 7,
                          None, TCTX)
        jx, _ = jdecode(_layer(jp["groups"]["layers"], i, False), jx, jz,
                        jnp.int32(7), None, JCTX)
        _close(tx, jx)
    t_tok = TL.greedy_token(tm.head_logits(tp["stem"], tx), cfg.vocab_size,
                            TCTX)
    j_tok = JL.greedy_token(jm.head_logits(jp["stem"], jx), jcfg.vocab_size,
                            JCTX)
    assert t_tok.tolist() == np.asarray(j_tok).tolist()


def test_leaf_names_match_the_reference():
    from repro.core.engine import _leaves_with_names as jax_names
    from repro_torch.core.serving import _leaves_with_names

    jcfg, cfg, jm, tm, jp, tp = _model_and_params("qwen3-0.6b")
    jl = _layer(jp["groups"]["layers"], 1, False)
    tl = _layer(tp["groups"]["layers"], 1, True)
    want = [(n, tuple(v.shape)) for n, v in jax_names(jl, "layers.1")]
    got = [(n, tuple(v.shape)) for n, v in _leaves_with_names(tl, "layers.1")]
    assert got == want
    assert got[0][0] == "layers.1['attn']['k_norm']"


# ---------------------------------------------------------------------------
# training: the loss and the gradients (torch.autograd against jax.vjp)
# ---------------------------------------------------------------------------


def _leaves(tree):
    """(path, leaf) pairs of a nested dict in JAX's order."""
    from repro_torch.models.api import flatten_with_paths

    return flatten_with_paths(tree)


def _grad_leaves(tree):
    return [t.detach().requires_grad_() for _, t in _leaves(tree)]


def test_vocab_parallel_xent_and_masked_mean_loss():
    """Padded vocab rows (V_local > vocab), a label outside the logits
    and a mask: the loss and its gradient equal the reference's,
    including the stop-gradient on the max shift."""
    from repro.models.api import masked_mean_loss as j_mean
    from repro_torch.models.api import masked_mean_loss as t_mean

    logits = _rand(30, 2, 5, 24) * 3
    labels = np.array([[1, 5, 19, 0, 3], [23, 7, 2, 30, 4]])
    mask = (np.arange(10).reshape(2, 5) % 3 != 0).astype(np.float32)

    def jloss(lg):
        per = JL.vocab_parallel_xent(lg, jnp.asarray(labels), 20, JCTX,
                                     mask=jnp.asarray(mask))
        return j_mean(per, None, jnp.float32(7.0))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    per = TL.vocab_parallel_xent(tl, torch.from_numpy(labels), 20, TCTX,
                                 mask=torch.from_numpy(mask))
    _close(per, JL.vocab_parallel_xent(jnp.asarray(logits),
                                       jnp.asarray(labels), 20, JCTX,
                                       mask=jnp.asarray(mask)))
    loss = t_mean(per, None, 7.0)
    (tg,) = torch.autograd.grad(loss, [tl])
    _close(loss, jl)
    _close(tg, jg)


@pytest.mark.parametrize("arch", _cfgs())
def test_head_loss_value_and_grads(arch):
    """Final norm + tied head + mean token loss: the value and the grads
    with respect to every stem leaf and the input."""
    jcfg, cfg, jm, tm, jp, tp = _model_and_params(arch)
    rng = np.random.default_rng(31)
    x = _rand(32, 2, 6, cfg.d_model)
    labels = rng.integers(0, cfg.vocab_size, (2, 6))
    jbatch = {"labels": jnp.asarray(labels), "global_tokens": jnp.float32(12)}
    tbatch = {"labels": torch.from_numpy(labels), "global_tokens": 12.0}
    loss, (jgs, jgx) = jax.jit(jax.value_and_grad(
        lambda s, xx: jm.head_loss(s, xx, jbatch), argnums=(0, 1)))(
        jp["stem"], jnp.asarray(x))
    leaves = _grad_leaves(tp["stem"])
    paths = [p for p, _ in _leaves(tp["stem"])]
    from repro_torch.models.api import unflatten

    tx = torch.from_numpy(x).requires_grad_()
    tloss = tm.head_loss(unflatten(paths, leaves), tx, tbatch)
    grads = torch.autograd.grad(tloss, leaves + [tx])
    _close(tloss, loss)
    for (_, want), got in zip(_leaves(jgs), grads[:-1]):
        _close(got, want)
    _close(grads[-1], jgx)


@pytest.mark.parametrize("arch", _cfgs())
def test_decoder_layer_grads(arch):
    """One decoder layer's full-sequence apply: the grads with respect to
    every param and the input for a random cotangent — the eager
    engine's BWD recompute."""
    jcfg, cfg, jm, tm, jp, tp = _model_and_params(arch)
    tg, jg = tm.groups()[0], jm.groups()[0]
    jl = _layer(jp["groups"]["layers"], 1, False)
    tl = _layer(tp["groups"]["layers"], 1, True)
    x, gy = _rand(33, 2, 6, cfg.d_model), _rand(34, 2, 6, cfg.d_model)
    jgp, jgx = jax.jit(lambda p, xx, g: jax.vjp(
        lambda pp, xxx: jg.apply(pp, xxx, None, JCTX)[0], p, xx)[1](g))(
        jl, jnp.asarray(x), jnp.asarray(gy))
    from repro_torch.models.api import unflatten

    leaves = _grad_leaves(tl)
    paths = [p for p, _ in _leaves(tl)]
    tx = torch.from_numpy(x).requires_grad_()
    ty, _ = tg.apply(unflatten(paths, leaves), tx, None, TCTX)
    grads = torch.autograd.grad(ty, leaves + [tx], torch.from_numpy(gy))
    want = _leaves(jgp)
    assert [p for p, _ in want] == paths
    for (_, w), got in zip(want, grads[:-1]):
        _close(got, w)
    _close(grads[-1], jgx)
