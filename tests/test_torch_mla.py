"""The port's MLA (``repro_torch.models.mla``) and deepseek-v2-lite against
the JAX package on the CPU, on the same numpy inputs and weights (fp32:
the same math summed in another order):

* ``mla_fwd``, ``mla_prefill`` (output and latent cache) and
  ``mla_decode`` (the absorbed decode over the latent cache) against the
  reference's at 1e-5 relative, and the twin of
  ``tests/test_attention.py::test_mla_decode_matches_fwd`` at tp=1;
* the per-row decode (a [B] position tensor: the compiled round's slots)
  against the int-position decode of each row alone, with the cache
  written in place;
* ``mla_fwd``'s gradients against ``jax.grad`` (``k_pe``'s sums over the
  heads through the expand);
* the plain K2 at a value head dim of its own (Dv != D, GQA included),
  forward against the reference's ``scan_attention`` and
  ``naive_attention`` and backward against ``jax.grad`` of
  ``naive_attention``; the kernel's head-dim pairs;
* deepseek-v2-lite-smoke's ``MoELM``: loss and every gradient against
  the reference's, both cache layouts (the dense layer's k/v, the MoE
  layers' latent) in one model;
* eager serving with paged KV against the reference's engine: greedy
  tokens and every per-round counter identical, the two cache layouts
  paged side by side; the compiled engine against the eager engine one
  sequence a decode call (counters) and batched (tokens);
* the chunk search at full width equal to the reference's, holding the
  largest expert tensor ([64, 2048, 1408]).

The chunked runtime (3 steps against the JAX runtime, then a decode),
the eager trainer (4 steps against the reference's engine), unpaged
serving and the train CLI run deepseek-v2-lite-smoke in
``tests/test_torch_zoo.py``'s parametrised cases.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.core.serving import ServingEngine as RefServing  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_bwd_ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models.api import flatten_with_paths  # noqa: E402
from repro_torch.runtime.serve import CompiledServingEngine  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-5
JCTX = JL.AxisCtx()
TCTX = TL.AxisCtx()
# the reference test's small MLA (test_attention.py::test_mla_decode_
# matches_fwd): 4 heads, latent 16, q/k 16 + 8, values 16
SMALL = dict(name="mla-t", d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
             d_ff=64, d_ff_expert=32, vocab_size=64, kv_lora_rank=16,
             qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, n_experts=4,
             top_k=2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def small():
    """The small MLA's weights (the reference's ``init_mla``) on both
    sides, and a [2, 10, 64] input."""
    jcfg, cfg = JaxMoEConfig(**SMALL), MoEConfig(**SMALL)
    jp = jax.tree_util.tree_map(
        np.asarray, JMLA.init_mla(jax.random.key(0), jcfg, 1, jnp.float32))
    return jcfg, cfg, jp, params_from_jax(jp), _rand(1, 2, 10, 64)


def _jtree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def test_mla_fwd_prefill_and_decode_match_the_reference(small):
    jcfg, cfg, jp, tp, x = small
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(TMLA.mla_fwd(tp, tx, cfg, TCTX),
           JMLA.mla_fwd(_jtree(jp), jx, jcfg, JCTX))
    ty, tcache = TMLA.mla_prefill(tp, tx, cfg, TCTX)
    jy, jcache = JMLA.mla_prefill(_jtree(jp), jx, jcfg, JCTX)
    _close(ty, jy)
    assert sorted(tcache) == sorted(jcache) == ["c", "k_pe"]
    for key in tcache:
        assert tuple(tcache[key].shape) == tuple(jcache[key].shape)
        _close(tcache[key], jcache[key])
    # decode at positions 10..12 on a 16-slot cache holding the prompt
    tc = TMLA.mla_init_cache(cfg, 2, 16, torch.float32)
    jc = JMLA.mla_init_cache(jcfg, 2, 16, jnp.float32, tp=1)
    for key in tc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        tc[key][:, :10] = tcache[key]
        jc[key] = jc[key].at[:, :10].set(jcache[key])
    for i, pos in enumerate(range(10, 13)):
        step = _rand(10 + i, 2, 1, 64)
        ty, tc_new = TMLA.mla_decode(tp, torch.from_numpy(step), tc, pos,
                                     cfg, TCTX)
        jy, jc = JMLA.mla_decode(_jtree(jp), jnp.asarray(step), jc, pos,
                                 jcfg, JCTX)
        assert tc_new["c"] is not tc["c"]  # int pos: a new cache
        tc = tc_new
        _close(ty, jy)
        for key in tc:
            _close(tc[key], jc[key])


def test_mla_decode_matches_fwd(small):
    """The twin of ``tests/test_attention.py::test_mla_decode_matches_fwd``
    at tp=1: decoding the sequence one token at a time from an empty
    cache gives the full forward's last row."""
    _, cfg, _, tp, x = small
    b, s = x.shape[:2]
    ref = TMLA.mla_fwd(tp, torch.from_numpy(x), cfg, TCTX)
    cache = TMLA.mla_init_cache(cfg, b, s, torch.float32)
    for i in range(s):
        y, cache = TMLA.mla_decode(tp, torch.from_numpy(x[:, i:i + 1]),
                                   cache, i, cfg, TCTX)
        torch.testing.assert_close(y[:, 0], ref[:, i], atol=2e-4, rtol=0)


def test_mla_per_row_decode_equals_each_row_alone(small):
    """The slot path of ``mla_decode`` (one position a row, a tensor) gives
    every row what an int-position decode of that row alone gives, and
    writes row b's latent at slot pos[b] of the cache in place."""
    _, cfg, _, tp, _ = small
    pos = torch.tensor([0, 5, 11, 3])
    b, c = len(pos), 16
    g = torch.Generator().manual_seed(3)
    x = torch.randn((b, 1, cfg.d_model), generator=g)
    cache = {"c": torch.randn((b, c, cfg.kv_lora_rank), generator=g),
             "k_pe": torch.randn((b, c, cfg.qk_rope_dim), generator=g)}
    before = {k: t.clone() for k, t in cache.items()}
    y, new = TMLA.mla_decode(tp, x, cache, pos, cfg, TCTX)
    assert new["c"] is cache["c"] and new["k_pe"] is cache["k_pe"]
    for i, n in enumerate(pos.tolist()):
        row = {k: t[i:i + 1] for k, t in before.items()}
        yi, ci = TMLA.mla_decode(tp, x[i:i + 1], row, n, cfg, TCTX)
        torch.testing.assert_close(y[i:i + 1], yi, rtol=1e-6, atol=1e-6)
        for k in cache:
            torch.testing.assert_close(cache[k][i:i + 1], ci[k])


def test_mla_fwd_gradients_match_jax_grad(small):
    jcfg, cfg, jp, tp, x = small
    tree = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    TMLA.mla_fwd(tree, tx, cfg, TCTX).square().sum().backward()

    def loss(p, xx):
        return jnp.sum(JMLA.mla_fwd(p, xx, jcfg, JCTX) ** 2)
    jg = jax.jit(jax.grad(loss, argnums=(0, 1)))(_jtree(jp), jnp.asarray(x))
    _close(tx.grad, jg[1], 1e-4)
    for key in tree:
        _close(tree[key].grad, jg[0][key], 1e-4)


@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_k2_with_its_own_value_head_dim(kvh, causal):
    """The plain K2 (the CPU's route of ``ops.flash_attention``) at q/k
    head dim 24 and value head dim 16, 4 query heads over ``kvh`` kv heads:
    the output against the reference's ``naive_attention`` and
    ``scan_attention`` (which take Dv != D), dq, dk and dv (autograd of
    the plain version, and the explicit plain backward) against
    ``jax.grad`` of ``naive_attention``."""
    b, s, h, d, dv = 2, 37, 4, 24, 16
    q, k, v = _rand(1, b, s, h, d), _rand(2, b, s, kvh, d), \
        _rand(3, b, s, kvh, dv)
    do = _rand(4, b, s, h, dv)
    scale = 1 / math.sqrt(d)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    if kvh != h:  # the reference's cores take GQA with kv repeated
        jk, jv = (jnp.repeat(t, h // kvh, axis=2) for t in (jk, jv))
    want = JL.naive_attention(jq, jk, jv, causal=causal, scale=scale)
    scan = JL.scan_attention(jq, jk, jv, causal=causal, scale=scale,
                             block=16)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, scale=scale)
    assert tuple(out.shape) == (b, s, h, dv)
    _close(out, want)
    _close(out, scan)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    def f(qq, kk, vv):
        if kvh != h:
            kk, vv = (jnp.repeat(t, h // kvh, axis=2) for t in (kk, vv))
        o = JL.naive_attention(qq, kk, vv, causal=causal, scale=scale)
        return jnp.sum(o * jnp.asarray(do))
    jg = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    o, lse = fa.plain(tq, tk, tv, causal=causal, scale=scale,
                      return_lse=True)
    explicit = flash_attention_bwd_ref(tq, tk, tv, o, lse,
                                       torch.from_numpy(do), causal=causal,
                                       scale=scale)
    for g, e, w in zip(got, explicit, jg):
        _close(g, w, 1e-4)
        _close(e, w, 1e-4)
        assert g.shape == e.shape


def test_k2_head_dim_pairs_and_their_schedules():
    """The kernels take (d, d) for the dense head dims (nemotron's 192
    among them) and MLA's (192, 128); a pair with Dv != D never plans the
    split-kv schedule, so a short prompt at (192, 128) runs the 128-row
    kernels, where (192, 192) decodes through the split kv."""
    assert fa.HEAD_PAIRS == ((32, 32), (64, 64), (96, 96), (128, 128),
                             (144, 144), (192, 192), (192, 128))
    cfg = get_config(ARCH)
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) in \
        fa.HEAD_PAIRS
    assert (cfg.head_dim, cfg.head_dim) in fa.HEAD_PAIRS  # the dense layer
    for sq, dtype, want in ((1, torch.bfloat16, "tc"),
                            (5, torch.float32, "tf32x3"),
                            (512, torch.bfloat16, "tc")):
        assert fa.plan_forward(1, sq, sq, 16, dtype,
                               head_dims=(192, 128)).schedule == want
    for dims in ((128, 128), (192, 192)):
        assert fa.plan_forward(1, 1, 64, 16, torch.bfloat16, kv_len=1,
                               head_dims=dims).schedule == "splitkv"


def _smoke():
    jcfg = jax_config(ARCH, smoke=True).replace(**FP32)
    cfg = get_config(ARCH, smoke=True).replace(**FP32)
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    tm = model_class(cfg)(cfg, TCTX)
    jparams = numpy_params(jm, 0)
    return jcfg, cfg, jm, tm, jparams


def test_moe_lm_loss_and_gradients_match_the_reference():
    """deepseek-v2-lite-smoke: a dense layer with GQA, then an MoE layer
    with MLA and a shared expert; the param tree's shapes, the two groups'
    cache layouts, the loss and every gradient against ``jax.grad``."""
    jcfg, cfg, jm, tm, jp = _smoke()
    assert [g.name for g in tm.groups()] == ["dense_layers", "moe_layers"]
    specs = jax.tree_util.tree_leaves_with_path(jm.param_specs())
    got = flatten_with_paths(tm.param_specs())
    assert [tuple(t.shape) for _, t in got] == \
        [tuple(s.shape) for _, s in specs]
    caches = {g.name: g.init_cache(1, 16) for g in tm.groups()}
    jcaches = {g.name: g.init_cache(1, 16) for g in jm.groups()}
    assert sorted(caches["dense_layers"]) == ["k", "v"]
    assert sorted(caches["moe_layers"]) == ["c", "k_pe"]
    for name in caches:
        for key, t in caches[name].items():
            assert tuple(t.shape) == tuple(jcaches[name][key].shape)
    tp = params_from_jax(jp)
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 40))
    batch = {"tokens": ids, "labels": np.roll(ids, -1, 1),
             "global_tokens": np.float32(ids.size)}

    def tloss(params):
        x, extras = tm.embed(params["stem"], {"tokens":
                                              torch.from_numpy(ids)})
        for g in tm.groups():
            for i in range(g.length):
                x, _ = g.apply(_unflat(params["groups"][g.name], i), x,
                               extras, TCTX)
        return tm.head_loss(params["stem"], x, {
            k: torch.as_tensor(v) for k, v in batch.items()})

    def jloss(params):
        x, extras = jm.embed(params["stem"], {"tokens": jnp.asarray(ids)})
        for g in jm.groups():
            for i in range(g.length):
                x, _ = g.apply(jax.tree_util.tree_map(
                    lambda t, _i=i: t[_i], params["groups"][g.name]), x,
                    extras, JCTX)
        return jm.head_loss(params["stem"], x, {
            k: jnp.asarray(v) for k, v in batch.items()})

    leaves = {p: t.clone().requires_grad_() for p, t in
              flatten_with_paths(tp)}
    tree = _rebuild(tp, leaves)
    loss = tloss(tree)
    loss.backward()
    jl, jg = jax.jit(jax.value_and_grad(jloss))(_jtree(jp))
    _close(loss, jl)
    jflat = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v
             for p, v in jax.tree_util.tree_leaves_with_path(jg)}
    for path, t in leaves.items():
        _close(t.grad, jflat[path], 1e-4)


def _unflat(group, i):
    return {k: (_unflat(v, i) if isinstance(v, dict) else v[i])
            for k, v in group.items()}


def _rebuild(tree, leaves, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    return leaves[path]


COUNTERS = ("admitted", "completed", "active", "queued", "prefill_tokens",
            "decode_tokens", "h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
            "critical_h2d_bytes", "prefetch_hits", "demand_misses",
            "peak_device_bytes")
NEW_TOKENS = [6, 3, 6, 4, 6, 6]


def _rows(eng):
    out = []
    while (m := eng.step_round()) is not None:
        assert m.peak_device_bytes <= eng.device_capacity
        out.append({f: getattr(m, f) for f in COUNTERS})
    eng.check_invariants()
    return out


def _serve(eng, prompts):
    rids = [eng.submit(p, n) for p, n in zip(prompts, NEW_TOKENS)]
    rows = _rows(eng)
    return [eng.result(r) for r in rids], rows


@pytest.fixture(scope="module")
def serving():
    jcfg, cfg, jm, _, jp = _smoke()
    rng = np.random.default_rng(2)
    # every prompt longer than a page: the reference's paged engine reads
    # a one-page request as a whole-horizon chunk (the port's does not)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 9, 12, 10, 12, 9)]
    return jcfg, cfg, jp, prompts


BUDGET = dict(device_memory_bytes=1_600_000, host_memory_bytes=24_000_000)


def test_paged_eager_serving_matches_the_reference(serving):
    """The dense layer's k/v pages and the MoE layer's latent pages side
    by side in one kv stream (8-token pages over a 24-token horizon):
    greedy tokens and every per-round counter equal the reference
    engine's, byte for byte, under a budget that pages."""
    jcfg, cfg, jp, prompts = serving
    kw = dict(BUDGET, max_seq_len=24, page_tokens=8)
    ref = RefServing(jax_model_class(jcfg), jcfg, init_params=jp, **kw)
    port = ServingEngine(model_class(cfg), cfg, device="cpu",
                         init_params=params_from_jax(jp), **kw)
    assert port._page_axes == {"dense_layers": [1, 1],
                               "moe_layers": [1, 1]}
    want, want_rows = _serve(ref, prompts)
    got, rows = _serve(port, prompts)
    assert got == want
    assert rows == want_rows
    assert port.pool.stats.d2h_bytes > 0  # the budget paged


@pytest.mark.parametrize("page_tokens", [None, 8])
def test_compiled_serving_matches_the_eager_engine(serving, page_tokens):
    """The compiled round (slots decoding from their own positions, the
    latent written in place per row) against the eager engine: tokens
    equal its batched run (which serves MoE one sequence a call), and,
    with prefill cohorts of one as the eager engine's MoE cohorts are,
    counters equal its run one sequence a decode call."""
    _, cfg, jp, prompts = serving
    kw = dict(BUDGET, max_seq_len=24, page_tokens=page_tokens)
    params = params_from_jax(jp)
    comp = CompiledServingEngine(model_class(cfg), cfg, device="cpu",
                                 init_params=params, **kw)
    got, _ = _serve(comp, prompts)
    eager = ServingEngine(model_class(cfg), cfg, device="cpu",
                          init_params=params, **kw)
    want, _ = _serve(eager, prompts)
    assert got == want
    comp = CompiledServingEngine(model_class(cfg), cfg, device="cpu",
                                 init_params=params, max_prefill_batch=1,
                                 **kw)
    got, rows = _serve(comp, prompts)
    assert got == want
    one = ServingEngine(model_class(cfg), cfg, device="cpu",
                        init_params=params, max_decode_batch=1,
                        max_prefill_batch=1, **kw)
    one_tokens, one_rows = _serve(one, prompts)
    assert one_tokens == got
    assert one_rows == rows
    assert comp.decode_compile_count == 1 and comp.padded_slots == 8


def test_chunk_search_at_full_width_holds_the_largest_expert_tensor():
    """deepseek-v2-lite at full width, its two groups (the dense layer and
    two MoE layers): the port's chunk search equals the reference's and
    its chunk holds the largest tensor, one layer's routed experts
    [64, 2048, 1408] (184.5 M elements); the chunk maps agree placement
    for placement."""
    from repro.core.chunk import TensorSpec as JSpec
    from repro.core.chunk import build_chunk_map as jax_build
    from repro.core.chunk import search_chunk_size as jax_search
    from repro_torch.core.chunk import TensorSpec, build_chunk_map, \
        search_chunk_size
    from repro_torch.core.serving import _leaves_with_names

    cfg = get_config(ARCH).replace(num_layers=3)
    tm = model_class(cfg)(cfg, TCTX)
    names = []
    for g in tm.groups():
        stacked = tm.param_specs()["groups"][g.name]
        names += [(f"{g.name}.{i}" + n[len("x"):], tuple(t.shape[1:]))
                  for i in range(g.length)
                  for n, t in _leaves_with_names(stacked, "x")]
    largest = max(int(np.prod(s)) for _, s in names)
    assert largest == 64 * 2048 * 1408 == 184_549_376
    specs = [TensorSpec(n, s) for n, s in names]
    got = search_chunk_size(specs, align=256)
    want = jax_search([JSpec(n, s) for n, s in names], align=256)
    assert got.chunk_size == want.chunk_size >= largest
    cmap = build_chunk_map(specs, got.chunk_size)
    ref = jax_build([JSpec(n, s) for n, s in names], got.chunk_size)
    assert [(p.name, p.chunk_id, p.offset) for p in cmap.placements] == \
        [(p.name, p.chunk_id, p.offset) for p in ref.placements]
