"""The port's Mamba2 (``repro_torch.models.ssm``) against the JAX package's
(``repro.models.ssm``) on the CPU, on the same numpy inputs and weights,
fp32 (the same math summed in another order, so 1e-5 relative):

* ``_causal_conv`` with and without a carry;
* ``_ssd_chunk_scan`` on its own;
* ``mamba2_fwd`` at a sequence length that ``chunk_len`` divides and at a
  ragged one (output, state and conv tails), and its gradients against
  ``jax.grad``;
* ``mamba2_decode`` from a prefilled state, against the reference's, and
  a prefill followed by decode steps equal to the full-sequence forward;
* finite gradients at a large ``dt``, where the reference's
  ``where(mask, exp(decay), 0)`` overflows past the diagonal and its
  gradient is NaN.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

ARCH = "zamba2-1.2b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-5
JCTX = JL.AxisCtx()
TCTX = TL.AxisCtx()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _jtree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _ttree(p):
    return params_from_jax(p)


@pytest.fixture(scope="module")
def cell():
    """zamba2-smoke's mamba layer (d 128, d_inner 256, 8 heads of 32,
    state 16, chunk 16): the reference's init with ``A_log``, ``dt_bias``
    and ``D`` drawn in their useful range."""
    jcfg = jax_config(ARCH, smoke=True).replace(**FP32)
    cfg = get_config(ARCH, smoke=True).replace(**FP32)
    jp = jax.tree_util.tree_map(
        np.asarray, JS.init_mamba2(jax.random.key(0), jcfg, 1, jnp.float32))
    rng = np.random.default_rng(3)
    nh = jcfg.mamba_heads
    jp = dict(jp, A_log=np.log(rng.uniform(1, 16, nh)).astype(np.float32),
              dt_bias=np.log(np.expm1(np.exp(rng.uniform(
                  np.log(1e-3), np.log(0.1), nh)))).astype(np.float32),
              D=(1 + 0.1 * rng.standard_normal(nh)).astype(np.float32))
    return jcfg, cfg, jp


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv_matches_the_reference(with_carry):
    x, kern = _rand(0, 2, 7, 12), _rand(1, 4, 12, scale=0.3)
    carry = _rand(2, 2, 3, 12) if with_carry else None
    ty, tc = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(kern),
                             None if carry is None else
                             torch.from_numpy(carry))
    jy, jc = JS._causal_conv(jnp.asarray(x), jnp.asarray(kern),
                             None if carry is None else jnp.asarray(carry))
    _close(ty, jy)
    _close(tc, jc)
    assert tuple(tc.shape) == (2, 3, 12)


def test_ssd_chunk_scan_matches_the_reference():
    b, nc, q, nh, dh, ds = 2, 3, 8, 4, 8, 6
    xh, bt, ct = (_rand(0, b, nc, q, nh, dh), _rand(1, b, nc, q, ds),
                  _rand(2, b, nc, q, ds))
    dt = np.abs(_rand(3, b, nc, q, nh, scale=0.1)) + 1e-3
    la = -dt * np.random.default_rng(4).uniform(1, 8, nh).astype(np.float32)
    s0 = _rand(5, b, nh, dh, ds)
    ty, ts = TS._ssd_chunk_scan(*(torch.from_numpy(a) for a in
                                  (xh, bt, ct, la, dt, s0)))
    jy, js = JS._ssd_chunk_scan(*(jnp.asarray(a) for a in
                                  (xh, bt, ct, la, dt, s0)))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("seq", [32, 21])
def test_mamba2_fwd_matches_the_reference(cell, seq):
    """S = 32 (two chunks of 16) and a ragged S = 21 (padded inside):
    output, final state and conv tails."""
    jcfg, cfg, jp = cell
    x = _rand(7, 2, seq, cfg.d_model)
    ty, (ts, tcc) = TS.mamba2_fwd(_ttree(jp), torch.from_numpy(x), cfg,
                                  TCTX)
    jy, (js, jcc) = jax.jit(lambda p, x: JS.mamba2_fwd(p, x, jcfg, JCTX))(
        _jtree(jp), jnp.asarray(x))
    _close(ty, jy)
    _close(ts, js)
    for key in ("x", "B", "C"):
        _close(tcc[key], jcc[key])


def test_mamba2_gradients_match_jax_grad(cell):
    jcfg, cfg, jp = cell
    x = _rand(8, 2, 21, cfg.d_model)
    gy = _rand(9, 2, 21, cfg.d_model)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (TS.mamba2_fwd(tp, tx, cfg, TCTX)[0] * torch.from_numpy(gy)).sum() \
        .backward()

    def jloss(p, x):
        return jnp.sum(JS.mamba2_fwd(p, x, jcfg, JCTX)[0] * gy)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(_jtree(jp),
                                                        jnp.asarray(x))
    _close(tx.grad, jgx, 1e-4)
    for key, t in tp.items():
        _close(t.grad, jgp[key], 1e-4)


def test_decode_continues_the_prefill(cell):
    """Prefill 19 positions, then decode 5 one at a time from the cached
    state and conv tails: each step equals the reference's decode and the
    full 24-position forward's row, and the final state equals it too."""
    jcfg, cfg, jp = cell
    tp, jpp = _ttree(jp), _jtree(jp)
    x = _rand(10, 2, 24, cfg.d_model)
    full, (fstate, _) = TS.mamba2_fwd(tp, torch.from_numpy(x), cfg, TCTX)
    _, (state, cc) = TS.mamba2_fwd(tp, torch.from_numpy(x[:, :19]), cfg,
                                   TCTX)
    cache = {"state": state, "conv_x": cc["x"], "conv_B": cc["B"],
             "conv_C": cc["C"]}
    jcache = jax.tree_util.tree_map(lambda t: jnp.asarray(_np(t)), cache)
    init = TS.mamba2_init_cache(cfg, 2, 1, torch.float32)
    jinit = JS.mamba2_init_cache(jcfg, 2, 1, jnp.float32)
    assert {k: tuple(t.shape) for k, t in init.items()} == \
        {k: tuple(t.shape) for k, t in jinit.items()}
    jdecode = jax.jit(lambda p, x, c: JS.mamba2_decode(p, x, c, jcfg, JCTX))
    for t in range(19, 24):
        step = x[:, t:t + 1]
        y, cache = TS.mamba2_decode(tp, torch.from_numpy(step), cache, cfg,
                                    TCTX)
        jy, jcache = jdecode(jpp, jnp.asarray(step), jcache)
        _close(y, jy)
        for key in cache:
            _close(cache[key], jcache[key])
        _close(y[:, 0], full[:, t])
    _close(cache["state"], fstate)


def test_gradients_stay_finite_at_a_large_dt(cell):
    """dt ~ 5 and |A| up to 16: past the diagonal a 16-step chunk's decay
    sums to ~1000, so the reference's exp overflows there and ``jax.grad`` gives
    NaN; the port masks before exp: finite gradients, and the same
    forward."""
    jcfg, cfg, jp = cell
    jp = dict(jp, dt_bias=np.full_like(jp["dt_bias"], 5.0))
    x = _rand(11, 1, 16, cfg.d_model)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty = TS.mamba2_fwd(tp, tx, cfg, TCTX)[0]
    ty.sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in tp.values())
    assert bool(torch.isfinite(tx.grad).all())

    def jloss(p, x):
        return jnp.sum(JS.mamba2_fwd(p, x, jcfg, JCTX)[0])

    _close(ty, JS.mamba2_fwd(_jtree(jp), jnp.asarray(x), jcfg, JCTX)[0])
    jg = jax.jit(jax.grad(jloss))(_jtree(jp), jnp.asarray(x))
    assert not np.isfinite(np.asarray(jg["w_dt"])).all()
