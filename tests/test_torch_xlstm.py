"""The port's xLSTM (``repro_torch.models.ssm``'s mLSTM and sLSTM,
``repro_torch.models.xlstm_lm``) against the JAX package on the CPU,
xlstm-smoke (4 layers: 2 units of 1 mLSTM + 1 sLSTM, d 128, d_inner 256,
4 heads of 64, ``chunk_len`` 16) in fp32, weights from
``_torch_parity.numpy_params`` through ``params_from_jax``.  Tolerances:
1e-5 relative on losses and activations (the same math summed in
another order), 1e-4 on gradients (absolute and relative, per element,
beside 1e-4 x the largest value), tokens and counters identical.

* the ops: ``_mlstm_chunk_scan`` with a carry in, ``mlstm_fwd`` at a
  ragged length (the padded carry the reference hands on), ``slstm_fwd``,
  each against ``jax.grad`` too; at large gate pre-activations, where
  the stabiliser's ``exp(-m)`` branch of the denominator is active;
* ``XLSTMLM``: the param tree and leaf dtypes (fp32 gates in a bf16
  model), the cache layouts, the loss and every gradient; prefill then
  decode against the reference's and against the full forward; the
  per-row decode (a [B] position tensor) equal to each row alone, every
  cache leaf written in place;
* the eager trainer's losses and counters against the reference engine;
  the rank-parallel plane (p = 2) against one rank;
* eager serving tokens and per-round counters under a budget that pages;
  paged KV raising in both packages; the compiled round against the
  eager engine one sequence a decode call;
* the chunked runtime on a (dp=2, tp=1) mesh against the JAX runtime,
  and ``RuntimeOptions(inner_remat=True, accum_steps=2)`` against the
  plain options (the twin of ``tests/test_perf_options.py``'s xlstm
  case, which runs at tp=2: the port has tp=1 only), and the SSD's
  inner checkpoint on zamba2-smoke.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.configs.base import InputShape as JaxShape  # noqa: E402
from repro.core.engine import PatrickStarEngine as RefEngine  # noqa: E402
from repro.core.serving import ServingEngine as RefServing  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jax_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro.runtime.step import RuntimeOptions as JaxOptions  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import params_from_jax, stores_from_jax  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistributedPatrickStarEngine,
)
from repro_torch.core.engine import PatrickStarEngine  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.api import flatten_with_paths, tree_map  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.serve import CompiledServingEngine  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

ARCH = "xlstm-1.3b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-5
GRAD_TOL = 1e-4  # absolute and relative, per element
JCTX = JL.AxisCtx()
TCTX = TL.AxisCtx()
# the reference's tuples, named: mLSTM's carry and sLSTM's state
MNAMES, SNAMES = ("S", "n", "m"), ("c", "n", "h", "m")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL):
    """Within ``tol`` of each element and ``tol`` x the largest |want|."""
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(scale, 1.0))


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _jtree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _unflat(group, i):
    return {k: (_unflat(v, i) if isinstance(v, dict) else v[i])
            for k, v in group.items()}


def _named(cache):
    """A reference cache (tuples) with the port's names."""
    if isinstance(cache, dict):
        return {k: _named(v) for k, v in cache.items()}
    names = MNAMES if len(cache) == 3 else SNAMES
    return dict(zip(names, cache))


def _close_tree(got, want, tol=TOL):
    want = dict(flatten_with_paths(_named(want)))
    got = dict(flatten_with_paths(got))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        _close(t, want[path], tol)


def _jitted(model_cls):
    """The reference model with its block groups' ``apply``, ``prefill``
    and ``decode`` under ``jax.jit`` (the context static), built once: its
    engines otherwise run op by op and compile hundreds of primitives."""
    class Jitted(model_cls):
        def groups(self):
            if not hasattr(self, "_jitted_groups"):
                self._jitted_groups = [dataclasses.replace(
                    g, apply=jax.jit(g.apply, static_argnums=3),
                    prefill=jax.jit(g.prefill, static_argnums=3),
                    decode=jax.jit(g.decode, static_argnums=5))
                    for g in super().groups()]
            return self._jitted_groups
    return Jitted


def _jflat(tree) -> dict:
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these smoke-size tensors: the suite runs
    several workers on the machine's cores, where idle pool threads only
    contend (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the ops
@pytest.fixture(scope="module")
def cells():
    """xlstm-smoke's mLSTM and sLSTM cells at the reference's init,
    fp32."""
    jcfg = jax_config(ARCH, smoke=True).replace(**FP32)
    cfg = get_config(ARCH, smoke=True).replace(**FP32)
    km, ks = jax.random.split(jax.random.key(0))

    def init(fn, key):  # jitted: op by op it takes seconds
        return jax.tree_util.tree_map(np.asarray, jax.jit(
            fn, static_argnums=(1, 2, 3))(key, jcfg, 1, jnp.float32))

    return (jcfg, cfg, init(JS.init_mlstm, km), init(JS.init_slstm, ks))


def _grads_match(tfn, jfn, args, tol=GRAD_TOL):
    """Output and the gradient of a fixed random projection of it, with
    respect to every argument, against ``jax.grad`` of the reference."""
    targs = [tree_map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(), a) if isinstance(a, dict) else
             torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = tfn(*targs)
    proj = _rand(99, *out.shape)
    (out * torch.from_numpy(proj)).sum().backward()
    jout, jg = jax.jit(jax.value_and_grad(
        lambda *a: (jfn(*a) * proj).sum(), argnums=tuple(range(len(args)))))(
            *[_jtree(a) for a in args])
    for t, g in zip(targs, jg):
        if isinstance(t, dict):
            for k in t:
                _close(t[k].grad, g[k], tol)
        else:
            _close(t.grad, g, tol)
    return out


def _carry(b, nh, dk, dv, seed):
    return {"S": _rand(seed, b, nh, dk, dv), "n": _rand(seed + 1, b, nh, dk),
            "m": _rand(seed + 2, b, nh)}


def test_mlstm_chunk_scan_with_a_carry_matches_the_reference():
    """Three chunks of 8 from a carry in: outputs and the carry handed
    on, then every input's gradient (the carry's too) against
    ``jax.grad``."""
    b, nc, q, nh, dk, dv = 2, 3, 8, 4, 8, 6
    qh, kh = _rand(0, b, nc, q, nh, dk), _rand(1, b, nc, q, nh, dk)
    vh, li = _rand(2, b, nc, q, nh, dv), _rand(3, b, nc, q, nh)
    lf = np.log(1 / (1 + np.exp(-(_rand(4, b, nc, q, nh) + 2)))
                ).astype(np.float32)
    carry = _carry(b, nh, dk, dv, 5)
    ty, tc = TS._mlstm_chunk_scan(*(torch.from_numpy(a) for a in
                                    (qh, kh, vh, li, lf)),
                                  tree_map(torch.from_numpy, carry))
    jy, jc = JS._mlstm_chunk_scan(*(jnp.asarray(a) for a in
                                    (qh, kh, vh, li, lf)),
                                  tuple(jnp.asarray(carry[k])
                                        for k in MNAMES))
    _close(ty, jy)
    _close_tree(tc, jc)

    def tfn(qh, kh, vh, li, lf, c):
        y, c = TS._mlstm_chunk_scan(qh, kh, vh, li, lf, c)
        return torch.cat([y.reshape(-1), c["S"].reshape(-1),
                          c["n"].reshape(-1), c["m"].reshape(-1)])

    def jfn(qh, kh, vh, li, lf, c):
        y, c = JS._mlstm_chunk_scan(qh, kh, vh, li, lf,
                                    tuple(c[k] for k in MNAMES))
        return jnp.concatenate([t.reshape(-1) for t in (y,) + c])

    _grads_match(tfn, jfn, [qh, kh, vh, li, lf, carry])


@pytest.mark.parametrize("seq", [32, 21])
def test_mlstm_fwd_matches_the_reference(cells, seq):
    """S = 32 (two chunks of 16) and a ragged S = 21, padded inside to
    32: output and the carry (its ``m`` raised by the padded steps, as the
    reference's), and the gradients of the input and every weight."""
    jcfg, cfg, jp, _ = cells
    x = _rand(7, 2, seq, cfg.d_model)
    ty, tc = TS.mlstm_fwd(params_from_jax(jp), torch.from_numpy(x), cfg,
                          TCTX)
    jy, jc = jax.jit(lambda p, x: JS.mlstm_fwd(p, x, jcfg, JCTX))(
        _jtree(jp), jnp.asarray(x))
    _close(ty, jy)
    _close_tree(tc, jc)
    if seq == 21:
        _grads_match(lambda p, x: TS.mlstm_fwd(p, x, cfg, TCTX)[0],
                     lambda p, x: JS.mlstm_fwd(p, x, jcfg, JCTX)[0],
                     [jp, x])


def test_slstm_fwd_matches_the_reference(cells):
    """13 positions from a random state: output, state, and the
    gradients of the input, the state and every weight."""
    jcfg, cfg, _, jp = cells
    x = _rand(8, 2, 13, cfg.d_model)
    nh, dh = cfg.n_heads, cfg.d_inner // cfg.n_heads
    st = {k: _rand(20 + i, 2, nh, dh) for i, k in enumerate(SNAMES)}
    st["n"] = np.abs(st["n"]) + 0.5
    ty, ts = TS.slstm_fwd(params_from_jax(jp), torch.from_numpy(x), cfg,
                          TCTX, state=tree_map(torch.from_numpy, st))
    jy, js = jax.jit(lambda p, x, s: JS.slstm_fwd(
        p, x, jcfg, JCTX, state=tuple(s[k] for k in SNAMES)))(
            _jtree(jp), jnp.asarray(x), _jtree(st))
    _close(ty, jy)
    _close_tree(ts, js)

    def tfn(p, x, s):
        y, s = TS.slstm_fwd(p, x, cfg, TCTX, state=s)
        return torch.cat([y.reshape(-1)] + [s[k].reshape(-1)
                                            for k in SNAMES])

    def jfn(p, x, s):
        y, s = JS.slstm_fwd(p, x, jcfg, JCTX,
                            state=tuple(s[k] for k in SNAMES))
        return jnp.concatenate([t.reshape(-1) for t in (y,) + s])

    _grads_match(tfn, jfn, [jp, x, st])
    # from zero (n = 1 exactly after the first step: the tie of
    # max(n, 1) splits its gradient as JAX's does)
    _grads_match(lambda p, x: TS.slstm_fwd(p, x, cfg, TCTX)[0],
                 lambda p, x: JS.slstm_fwd(p, x, jcfg, JCTX)[0], [jp, x])


@pytest.mark.parametrize("seq", [32, 21])
def test_gradients_match_at_large_gate_preactivations(cells, seq):
    """Input gates up to ~+-120 and forget gates near 0 or 1: the
    stabiliser swings past exp's range.  At S = 32 (no padding) every
    gradient equals ``jax.grad``'s.  At the ragged S = 21 a padded row
    (q = 0) meets exp(-m) = 0 and divides 0 by 0: the reference's
    gradients turn NaN through it (a hazard of the reference), the
    port's stay finite and equal the reference's wherever those are
    finite."""
    jcfg, cfg, jp, _ = cells
    jp = dict(jp, w_i=jp["w_i"] * 60, w_f=jp["w_f"] * 30,
              f_bias=np.full_like(jp["f_bias"], -3.0))
    x = _rand(9, 2, seq, cfg.d_model)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(),
                  jp)
    tx = torch.from_numpy(x).requires_grad_()
    ty, _ = TS.mlstm_fwd(tp, tx, cfg, TCTX)
    proj = _rand(98, *ty.shape)
    (ty * torch.from_numpy(proj)).sum().backward()
    jy, jg = jax.jit(jax.value_and_grad(
        lambda p, x: (JS.mlstm_fwd(p, x, jcfg, JCTX)[0] * proj).sum(),
        argnums=(0, 1)))(_jtree(jp), jnp.asarray(x))
    assert np.isfinite(float(jy))
    mine = dict(tp, x=tx)
    want = dict(jg[0], x=jg[1])
    finite = {key: bool(np.isfinite(_np(g)).all()) for key, g in
              want.items()}
    assert all(finite.values()) == (seq == 32), finite
    for key, t in mine.items():
        assert np.isfinite(_np(t.grad)).all(), key
        if finite[key]:
            _close(t.grad, want[key], GRAD_TOL)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def smoke():
    """Both models, the weights, a [2, 24] batch (ragged against the
    16-position chunks) and ``jax.grad`` of the reference model's whole
    loss (computed once)."""
    jcfg = jax_config(ARCH, smoke=True).replace(**FP32)
    cfg = get_config(ARCH, smoke=True).replace(**FP32)
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    tm = model_class(cfg)(cfg, TCTX)
    jp = numpy_params(jm, 0)
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24))
    batch = {"tokens": ids, "labels": np.roll(ids, -1, 1),
             "global_tokens": np.float32(ids.size)}

    def jloss(params):
        x, extras = jm.embed(params["stem"], {"tokens": jnp.asarray(ids)})
        for g in jm.groups():
            for i in range(g.length):
                x, _ = g.apply(jax.tree_util.tree_map(
                    lambda t, _i=i: t[_i], params["groups"][g.name]), x,
                    extras, JCTX)
        return jm.head_loss(params["stem"], x, {
            k: jnp.asarray(v) for k, v in batch.items()})

    jl, jg = jax.jit(jax.value_and_grad(jloss))(_jtree(jp))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, tm=tm, jp=jp, batch=batch,
                loss=float(jl), grads=_jflat(jg))


def test_xlstm_lm_loss_and_gradients_match_the_reference(smoke):
    """The param tree (mLSTM layers stacked [units, 1, ...]), the leaf
    dtypes of a bf16 model (the gates fp32), the cache layouts, the loss
    and every gradient."""
    cfg, jm, tm = smoke["cfg"], smoke["jm"], smoke["tm"]
    assert [g.name for g in tm.groups()] == ["units"]
    assert model_class(get_config(ARCH)).__name__ == "XLSTMLM"
    specs = jax.tree_util.tree_leaves_with_path(jm.param_specs())
    got = flatten_with_paths(tm.param_specs())
    assert [tuple(t.shape) for _, t in got] == \
        [tuple(s.shape) for _, s in specs]
    bf = get_config(ARCH, smoke=True)
    jbf = jax_config(ARCH, smoke=True)
    assert [str(t.dtype).split(".")[-1] for _, t in flatten_with_paths(
        model_class(bf)(bf, TCTX).param_specs())] == \
        [str(s.dtype) for s in jax.tree_util.tree_leaves(
            jax_model_class(jbf)(jbf, JCTX).param_specs())]
    for g, jg in zip(tm.groups(), jm.groups()):
        mine = dict(flatten_with_paths(g.init_cache(2, 16)))
        want = dict(flatten_with_paths(_named(jg.init_cache(2, 16))))
        assert sorted(mine) == sorted(want)
        for path, t in mine.items():
            assert tuple(t.shape) == tuple(want[path].shape), path
            assert t.dtype == torch.float32
            _close(t, want[path])
    tp = params_from_jax(smoke["jp"])
    leaves = {p: t.clone().requires_grad_() for p, t in
              flatten_with_paths(tp)}

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        return leaves[path]

    params = rebuild(tp)
    ids = smoke["batch"]["tokens"]
    x, extras = tm.embed(params["stem"], {"tokens": torch.from_numpy(ids)})
    for g in tm.groups():
        for i in range(g.length):
            x, _ = g.apply(_unflat(params["groups"][g.name], i), x, extras,
                           TCTX)
    loss = tm.head_loss(params["stem"], x, {
        k: torch.as_tensor(v) for k, v in smoke["batch"].items()})
    loss.backward()
    want = smoke["loss"]
    assert abs(float(loss.detach()) - want) <= TOL * abs(want)
    for path, t in leaves.items():
        _close(t.grad, smoke["grads"][path], GRAD_TOL)


def _prefill(model, ctx, params, ids, unflat):
    x, extras = model.embed(params["stem"], {"tokens": ids})
    caches = []
    g = model.groups()[0]
    for i in range(g.length):
        x, c = g.prefill(unflat(params["groups"][g.name], i), x, extras,
                         ctx)
        caches.append(c)
    return x, caches


def test_prefill_and_decode_match_the_reference_and_the_forward(smoke):
    """Prefill 21 tokens (ragged against 16), then 3 decode steps at int
    positions: hidden states, head logits and every cache leaf against
    the reference's; and the decoded hidden states equal the full
    forward's over the 24 tokens."""
    cfg, jm, tm = smoke["cfg"], smoke["jm"], smoke["tm"]
    jp, tp = _jtree(smoke["jp"]), params_from_jax(smoke["jp"])
    ids = smoke["batch"]["tokens"]
    jtake = (lambda grp, i: jax.tree_util.tree_map(lambda t: t[i], grp))
    tx, tcs = _prefill(tm, TCTX, tp, torch.from_numpy(ids[:, :21]), _unflat)
    jx, jcs = jax.jit(lambda p, i: _prefill(jm, JCTX, p, i, jtake))(
        jp, jnp.asarray(ids[:, :21]))
    _close(tx, jx)
    for tc, jc in zip(tcs, jcs):
        _close_tree(tc, jc)
    # the full forward's hidden states at every position
    fx, _ = tm.embed(tp["stem"], {"tokens": torch.from_numpy(ids)})
    g = tm.groups()[0]
    for i in range(g.length):
        fx, _ = g.apply(_unflat(tp["groups"]["units"], i), fx, None, TCTX)
    jg = jm.groups()[0]

    def jdecode(p, tok, caches, pos):
        x = jm.embed_decode(p["stem"], tok, pos, None)
        new = []
        for i in range(jg.length):
            x, c = jg.decode(jtake(p["groups"]["units"], i), x, caches[i],
                             pos, None, JCTX)
            new.append(c)
        return x, jm.head_logits(p["stem"], x), new

    jdecode = jax.jit(jdecode)
    for pos in range(21, 24):
        tok = ids[:, pos:pos + 1]
        jh, jl, jcs = jdecode(jp, jnp.asarray(tok), jcs, jnp.int32(pos))
        tx = tm.embed_decode(tp["stem"], torch.from_numpy(tok), pos, None)
        for i in range(g.length):
            tx, tcs[i] = g.decode(_unflat(tp["groups"]["units"], i), tx,
                                  tcs[i], pos, None, TCTX)
        _close(tx, jh)
        _close(tx, fx[:, pos:pos + 1])
        _close(tm.head_logits(tp["stem"], tx), jl, 1e-4)
    for tc, jc in zip(tcs, jcs):
        _close_tree(tc, jc)


def test_per_row_decode_equals_each_row_alone(smoke):
    """A [B] position tensor (the compiled round's slots): the unit cache
    is written in place and returned, and each row equals an
    int-position decode of that row alone."""
    cfg, tm = smoke["cfg"], smoke["tm"]
    tp = params_from_jax(smoke["jp"])
    rng = np.random.default_rng(5)
    g = tm.groups()[0]
    p = _unflat(tp["groups"]["units"], 0)
    cache = tree_map(lambda t: torch.from_numpy(rng.standard_normal(
        tuple(t.shape)).astype(np.float32)), g.init_cache(2, 16))
    before = tree_map(lambda t: t.clone(), cache)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
    pos = torch.tensor([3, 9])
    x = tm.embed_decode(tp["stem"], tok, pos, None)
    y, out = g.decode(p, x, cache, pos, None, TCTX)
    assert out is cache
    axes = driver.cache_batch_axes(g, 16)
    assert axes == {"mlstm": {"S": 1, "n": 1, "m": 1},
                    "slstm": {"c": 0, "n": 0, "h": 0, "m": 0}}
    for r in range(2):
        yr, cr = g.decode(p, x[r:r + 1], _pick(before, axes, r),
                          int(pos[r]), None, TCTX)
        _close(y[r:r + 1], yr)
        for (_, a), (_, b) in zip(flatten_with_paths(_pick(out, axes, r)),
                                  flatten_with_paths(cr)):
            _close(a, b)


def _pick(tree, axes, r):
    """Row ``r`` of a batched cache tree, each leaf sliced (kept) at its
    batch axis."""
    if isinstance(tree, dict):
        return {k: _pick(v, axes[k], r) for k, v in tree.items()}
    return tree.narrow(axes, r, 1)


# ---------------------------------------------------------------- training
TRAIN_COUNTERS = ("h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
                  "critical_h2d_bytes", "prefetch_hits", "demand_misses")


def test_eager_trainer_matches_the_reference_engine(smoke):
    """2 steps of the eager trainer (OPT, prefetch, the act stream, a
    budget that pages) from the same weights: losses within 1e-5
    relative of the reference engine's, and its per-step counters
    identical."""
    cfg, jcfg = smoke["cfg"], smoke["jcfg"]
    kw = dict(device_memory_bytes=4_000_000, policy="opt", lr=1e-3)
    ref = RefEngine(_jitted(jax_model_class(jcfg)), jcfg,
                    init_params=smoke["jp"], **kw)
    eng = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                            init_params=params_from_jax(smoke["jp"]), **kw)
    got, want = [], []
    for _ in range(2):
        want.append(ref.step(smoke["batch"]))
        got.append(eng.step(smoke["batch"]))
    for a, b in zip(got, want):
        assert abs(a.loss - b.loss) <= TOL * abs(b.loss), (a.loss, b.loss)
        assert {f: getattr(a, f) for f in TRAIN_COUNTERS} == \
            {f: getattr(b, f) for f in TRAIN_COUNTERS}
    assert got[-1].loss < got[0].loss
    assert sum(m.d2h_bytes for m in got) > 0  # the budget paged


def test_rank_parallel_plane_takes_the_same_steps(smoke):
    """p = 2 (the batch split over two simulated ranks, grads
    reduce-scattered, the stem's summed): the stem gradient handed to the
    first update equals the single-rank engine's, and the losses of 2
    steps agree."""
    cfg = smoke["cfg"]
    params = params_from_jax(smoke["jp"])
    seen = {}

    def capture(core, key):
        orig = core.update_stem

        def wrapped(stem_grad):
            seen.setdefault(key, [g.clone() for g in stem_grad])
            return orig(stem_grad)
        core.update_stem = wrapped

    kw = dict(device="cpu", device_memory_bytes=4_000_000, lr=1e-3,
              init_params=params)
    one = PatrickStarEngine(model_class(cfg), cfg, **kw)
    two = DistributedPatrickStarEngine(model_class(cfg), cfg, nproc=2, **kw)
    capture(one, "one")
    capture(two.ranks[0], "two")
    losses = [(one.step(smoke["batch"]).loss, two.step(smoke["batch"]).loss)
              for _ in range(2)]
    for a, b in losses:
        assert abs(a - b) <= TOL * abs(a), losses
    for a, b in zip(seen["one"], seen["two"]):
        _close(b, a, GRAD_TOL)


# ---------------------------------------------------------------- serving
COUNTERS = ("admitted", "completed", "active", "queued", "prefill_tokens",
            "decode_tokens", "h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
            "critical_h2d_bytes", "prefetch_hits", "demand_misses",
            "peak_device_bytes")
NEW_TOKENS = [3, 2]
BUDGET = dict(device_memory_bytes=3_900_000, host_memory_bytes=24_000_000,
              max_seq_len=24)


def _serve(eng, prompts):
    rids = [eng.submit(p, n) for p, n in zip(prompts, NEW_TOKENS)]
    rows = []
    while (m := eng.step_round()) is not None:
        assert m.peak_device_bytes <= eng.device_capacity
        rows.append({f: getattr(m, f) for f in COUNTERS})
    eng.check_invariants()
    return [eng.result(r) for r in rids], rows


@pytest.fixture(scope="module")
def prompts(smoke):
    rng = np.random.default_rng(2)
    return [rng.integers(0, smoke["cfg"].vocab_size, size=n).astype(
        np.int32) for n in (19, 17)]


def test_eager_serving_matches_the_reference(smoke, prompts):
    """One sequence a call (the mLSTM carries do not lead with the batch
    dim), ragged prompts against the 16-position chunks, the fp32 carries
    in one kv chunk a unit: greedy tokens and every per-round counter
    equal the reference engine's."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    ref = RefServing(_jitted(jax_model_class(jcfg)), jcfg,
                     init_params=smoke["jp"], **BUDGET)
    port = ServingEngine(model_class(cfg), cfg, device="cpu",
                         init_params=params_from_jax(smoke["jp"]), **BUDGET)
    assert port._batchable == {"units": False}
    want, want_rows = _serve(ref, prompts)
    got, rows = _serve(port, prompts)
    assert got == want
    assert rows == want_rows
    assert port.pool.stats.d2h_bytes > 0  # the budget paged


def test_batched_serving_keeps_one_sequence_a_call(smoke):
    """xlstm-smoke's mLSTM carries are [1, B, ...] (one layer stacked
    ahead of the batch): the reference reads a leading 1 as the batch dim
    and fails to store a batched prefill; the port finds the batch axis
    behind the layer axis, serves one sequence a call at any batch
    limit, and gives the tokens of a run with limits of one."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
               for _ in range(2)]
    kw = dict(BUDGET, device_memory_bytes=40_000_000)
    with pytest.raises(ValueError, match="exceeds template"):
        _serve(RefServing(_jitted(jax_model_class(jcfg)), jcfg,
                          init_params=smoke["jp"], max_decode_batch=2,
                          max_prefill_batch=2, **kw), prompts)
    params = params_from_jax(smoke["jp"])
    runs = [_serve(ServingEngine(model_class(cfg), cfg, device="cpu",
                                 init_params=params, max_decode_batch=n,
                                 max_prefill_batch=n, **kw), prompts)[0]
            for n in (2, 1)]
    assert runs[0] == runs[1]


def test_paged_kv_raises_for_the_recurrent_state(smoke):
    """The reference's ``test_unpageable_cache_arch_rejected``, in both
    packages."""
    kw = dict(BUDGET, page_tokens=8)
    with pytest.raises(ValueError, match="position axis"):
        RefServing(jax_model_class(smoke["jcfg"]), smoke["jcfg"],
                   init_params=smoke["jp"], **kw)
    with pytest.raises(ValueError, match="position axis"):
        ServingEngine(model_class(smoke["cfg"]), smoke["cfg"], device="cpu",
                      init_params=params_from_jax(smoke["jp"]), **kw)


def test_compiled_round_matches_the_eager_engine(smoke, prompts):
    """Slot caches put the slots where each leaf's batch axis is (the
    mLSTM carries [tp, L, 1, S_slots, ...], the sLSTM state [tp, L,
    S_slots, ...]): tokens equal the eager engine's, and with prefill
    cohorts of one the counters equal its run one sequence a decode
    call."""
    cfg = smoke["cfg"]
    params = params_from_jax(smoke["jp"])
    eager = ServingEngine(model_class(cfg), cfg, device="cpu",
                          init_params=params, max_decode_batch=1,
                          max_prefill_batch=1, **BUDGET)
    want, want_rows = _serve(eager, prompts)
    comp = CompiledServingEngine(model_class(cfg), cfg, device="cpu",
                                 init_params=params, max_prefill_batch=1,
                                 **BUDGET)
    assert comp._slot_axis["units"][("mlstm", "S")] == 3
    assert comp._slot_axis["units"][("slstm", "c")] == 2
    got, rows = _serve(comp, prompts)
    assert got == want
    assert rows == want_rows
    assert comp.decode_compile_count == 1 and comp.padded_slots == 2


# ---------------------------------------------------------------- runtime
def _batch(cfg, b, s, seed):
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return {"tokens": ids, "labels": np.roll(ids, -1, 1),
            "global_tokens": np.float32(ids.size)}


def test_runtime_matches_the_reference_runtime(smoke):
    """The chunked-ZeRO runtime on a (dp=2, tp=1) mesh, 2 steps of
    4 x 24 from the reference's own state: losses within 1e-5 relative of
    the JAX runtime's, then a decode step whose greedy tokens equal the
    reference's."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(2, 1),
                     JaxOptions())
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(2, 1, device="cpu"), RuntimeOptions())
    jps, jos = jax_driver.init_state(jrt, jax.random.key(0))
    ps, os_ = driver.place_state(rt, *stores_from_jax(jax.device_get(jps),
                                                      jax.device_get(jos)))
    jstep, _, _ = jax_driver.build_train_step(
        jrt, JaxShape("smoke", 24, 4, "train"))
    step, _, _ = driver.build_train_step(rt, InputShape("smoke", 24, 4,
                                                        "train"))
    batch = _batch(cfg, 4, 24, 1)
    for i in range(2):
        jps, jos, jm = jstep(jps, jos, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                             jnp.int32(i))
        ps, os_, m = step(ps, os_, batch, i)
        ref, got = float(jm["loss"]), float(m["loss"])
        assert np.isfinite(got) and abs(got - ref) <= TOL * abs(ref), \
            (i, ref, got)
    dshape = InputShape("serve", 24, 4, "decode")
    dec, _ = driver.build_decode_step(rt, dshape)
    tok = np.zeros((4, 1), np.int32)
    nxt, _ = dec(ps, driver.init_caches(rt, dshape), tok, 5)
    jshape = JaxShape("serve", 24, 4, "decode")
    jdec, _ = jax_driver.build_decode_step(jrt, jshape)
    jnxt, _ = jdec(jps, jax_driver.init_caches(jrt, jshape),
                   jnp.asarray(tok), jnp.int32(5))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


@pytest.mark.parametrize("arch", [ARCH, "zamba2-1.2b"])
def test_inner_remat_keeps_the_training_math(arch):
    """``RuntimeOptions(inner_remat=True)`` checkpoints each step of the
    inner scans (mLSTM's chunks and sLSTM's positions; zamba's SSD
    chunks): the runtime's context carries it, and 2 steps of 4 x 32 at
    (dp=2, tp=1) give the plain options' loss within 5e-5 — for xlstm
    with ``accum_steps=2`` too, the twin of the reference's
    ``tests/test_perf_options.py`` case (4 x 64 at tp=2 there; the port
    has tp=1 only; 32 positions are two chunks of the scans)."""
    cfg = get_config(arch, smoke=True).replace(**FP32)
    if arch == "zamba2-1.2b":
        cfg = cfg.replace(num_layers=2)
    params = model_class(cfg)(cfg, TCTX).init_params(
        torch.Generator().manual_seed(0))
    batch = _batch(cfg, 4, 32, 1)
    extra = dict(accum_steps=2) if arch == ARCH else {}

    def loss(opt):
        rt = ChunkedRuntime(model_class(cfg), cfg,
                            make_smoke_mesh(2, 1, device="cpu"), opt)
        assert rt.ctx.inner_remat == opt.inner_remat
        ps, os_ = driver.init_state(rt, params=params)
        step, _, _ = driver.build_train_step(
            rt, InputShape("t", 32, 4, "train"))
        for i in range(2):
            ps, os_, m = step(ps, os_, batch, i)
        return float(m["loss"])

    base = loss(RuntimeOptions())
    got = loss(RuntimeOptions(inner_remat=True, **extra))
    assert abs(base - got) < 5e-5 * max(abs(base), 1.0), (base, got)
