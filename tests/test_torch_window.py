"""Sliding-window attention in the port against ``repro.models.layers``
on the same numpy inputs (fp32 tolerance 1e-5), and the port's decode
ring against full-sequence windowed attention:

* ``naive_attention`` and ``scan_attention`` with a window (the twin of
  ``tests/test_attention.py::test_sliding_window_masks``);
* ``attention_fwd``, ``attention_prefill`` and ``attention_decode`` on
  mixtral's smoke config (window 32) for prompts no longer than the window
  and for multiples of it, where the reference's ring is right;
* the ring past the window at lengths that are not a multiple of it (11
  with window 8): each decode step, in both forms (an int position, and
  one position a row as the compiled round calls it), equals that row of
  windowed ``attention_fwd`` over the whole sequence.  The reference's
  tp=1 prefill keeps the last ``window`` rows in prompt order, so its
  decode overwrites the wrong slot here: the port is held to the full
  attention, not to the reference;
* the ring needs no mask: a row's visible slots are the first
  ``min(pos + 1, C)``, which equals the reference's ``valid`` mask;
* the plain windowed backward (``kernels.ref``: the explicit formulas,
  and autograd through the plain forward) against ``jax.vjp`` of the
  reference's ``naive_attention`` with a window.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = 1e-5
JCTX = JL.AxisCtx()
TCTX = TL.AxisCtx()
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _qkv(seed, b, s, h, kv, d):
    return _rand(seed, b, s, h, d), _rand(seed + 1, b, s, kv, d), \
        _rand(seed + 2, b, s, kv, d)


@pytest.mark.parametrize("window", [1, 5, 8, 31, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_naive_and_scan_windows_match_the_reference(window, causal):
    q, k, v = _qkv(0, 1, 32, 4, 2, 8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = JL.naive_attention(jq, jk, jv, causal=causal, window=window)
    _close(TL.naive_attention(tq, tk, tv, causal=causal, window=window),
           want)
    _close(TL.scan_attention(tq, tk, tv, causal=causal, window=window,
                             block=8),
           JL.scan_attention(jq, jk, jv, causal=causal, window=window,
                             block=8))
    _close(TL.scan_attention(tq, tk, tv, causal=causal, window=window,
                             block=8), want)
    if window < 32 and causal:
        full = TL.naive_attention(tq, tk, tv, causal=True)
        assert not np.allclose(full.numpy(), _np(want))


def _attn_pair(window=None):
    jcfg = jax_config("mixtral-8x7b", smoke=True).replace(**FP32)
    cfg = get_config("mixtral-8x7b", smoke=True).replace(**FP32)
    if window is not None:
        jcfg, cfg = (c.replace(sliding_window=window) for c in (jcfg, cfg))
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    jp = numpy_params(jm, 0)
    jl = jax.tree_util.tree_map(lambda t: jnp.asarray(t[0]),
                                jp["groups"]["moe_layers"]["attn"])
    tl = {k: torch.from_numpy(np.asarray(v[0])) for k, v in
          jp["groups"]["moe_layers"]["attn"].items()}
    return jcfg, cfg, jl, tl


@pytest.mark.parametrize("s", [20, 32, 64])
def test_attention_blocks_with_a_window_match_the_reference(s):
    """Prefill, then three decode steps, against the reference, on lengths
    where its ring is laid out right (no longer than the window, or a
    multiple of it)."""
    jcfg, cfg, jl, tl = _attn_pair()
    assert cfg.sliding_window == 32
    b = 2
    x = _rand(10, b, s, cfg.d_model)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(TL.attention_fwd(tl, tx, cfg, TCTX),
           jax.jit(JL.attention_fwd, static_argnums=(2, 3))(jl, jx, jcfg,
                                                            JCTX))
    ty, tcache = TL.attention_prefill(tl, tx, cfg, TCTX)
    jy, jcache = jax.jit(JL.attention_prefill, static_argnums=(2, 3))(
        jl, jx, jcfg, JCTX)
    _close(ty, jy)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    horizon = s + 8
    tz = TL.attention_init_cache(cfg, b, horizon, 1, torch.float32)
    jz = JL.attention_init_cache(jcfg, b, horizon, 1, jnp.float32)
    assert tz["k"].shape == jz["k"].shape == (b, min(horizon, 32), 2, 32)
    n = tcache["k"].shape[1]
    for key in ("k", "v"):
        tz[key][:, :n] = tcache[key]
        jz[key] = jz[key].at[:, :n].set(jcache[key])
    jdec = jax.jit(JL.attention_decode, static_argnums=(4, 5))
    for step in range(3):
        xd = _rand(11 + step, b, 1, cfg.d_model)
        ty, tz = TL.attention_decode(tl, torch.from_numpy(xd), tz, s + step,
                                     cfg, TCTX)
        jy, jz = jdec(jl, jnp.asarray(xd), jz, jnp.int32(s + step), jcfg,
                      JCTX)
        _close(ty, jy)
        for key in ("k", "v"):
            _close(tz[key], jz[key])


@pytest.mark.parametrize("prompt,window,steps", [(11, 8, 3), (13, 8, 6),
                                                 (5, 4, 7), (8, 8, 2)])
@pytest.mark.parametrize("form", ["int", "rows"])
def test_the_ring_past_the_window_equals_full_windowed_attention(
        prompt, window, steps, form):
    """The port's ring (prefill laid out at ``slot = pos % window``, each
    decode step writing its slot) against windowed ``attention_fwd`` over
    the whole sequence: row ``pos`` of it is what decode at ``pos`` must
    return."""
    _, cfg, _, tl = _attn_pair(window)
    b, total = 2, prompt + steps
    x = torch.from_numpy(_rand(20, b, total, cfg.d_model))
    full = TL.attention_fwd(tl, x, cfg, TCTX)
    y, cache = TL.attention_prefill(tl, x[:, :prompt], cfg, TCTX)
    _close(y, full[:, :prompt])
    z = TL.attention_init_cache(cfg, b, total + 4, 1, torch.float32)
    assert z["k"].shape[1] == window
    n = cache["k"].shape[1]
    assert n == min(prompt, window)
    for key in ("k", "v"):
        z[key][:, :n] = cache[key]
    for pos in range(prompt, total):
        xd = x[:, pos:pos + 1]
        if form == "int":
            y, z = TL.attention_decode(tl, xd, z, pos, cfg, TCTX)
        else:
            y, z = TL.attention_decode(tl, xd, z,
                                       torch.full((b,), pos), cfg, TCTX)
        _close(y, full[:, pos:pos + 1])


def test_the_reference_prefill_ring_is_wrong_past_a_ragged_window():
    """The hazard the port works around: the reference's tp=1 prefill keeps
    the last ``window`` rows in prompt order, so with 11 tokens and window
    8 its decode disagrees with its own full-sequence attention."""
    jcfg, _, jl, _ = _attn_pair(8)
    x = jnp.asarray(_rand(20, 1, 12, jcfg.d_model))
    full = JL.attention_fwd(jl, x, jcfg, JCTX)
    _, cache = JL.attention_prefill(jl, x[:, :11], jcfg, JCTX)
    z = JL.attention_init_cache(jcfg, 1, 16, 1, jnp.float32)
    z = {k: z[k].at[:, :8].set(cache[k]) for k in z}
    y, _ = JL.attention_decode(jl, x[:, 11:12], z, jnp.int32(11), jcfg, JCTX)
    assert float(jnp.abs(y - full[:, 11:12]).max()) > 1e-2


@pytest.mark.parametrize("c", [8, 16])
def test_ring_visible_length_equals_the_reference_valid_mask(c):
    """``min(pos + 1, C)`` leading slots, per row (the compiled round's
    ``kv_lens``), against the reference's ring mask ``valid`` for a window
    of C (its ``attention_decode``): the same slots at every position."""
    for pos in range(0, 3 * c):
        slot = pos % c
        j = np.arange(c)
        slot_pos = pos - np.mod(slot - j, c)
        valid = (slot_pos >= 0) & (slot_pos > pos - c)
        assert (valid == (j < min(pos + 1, c))).all(), pos
    q = torch.from_numpy(_rand(30, 3, 1, 4, 32))
    k = torch.from_numpy(_rand(31, 3, c, 2, 32))
    v = torch.from_numpy(_rand(32, 3, c, 2, 32))
    pos = torch.tensor([1, c - 1, 3 * c + 2])
    rows = TL._decode_attend(q, k, v, pos)
    for r, p in enumerate(pos.tolist()):
        jpos = jnp.int32(p)
        slot = jnp.mod(jpos, c)
        jj = jnp.arange(c)
        slot_pos = jpos - jnp.mod(slot - jj, c)
        valid = (slot_pos >= 0) & (slot_pos > jpos - c)
        want = JL._decode_attend(jnp.asarray(q[r:r + 1].numpy()),
                                 jnp.asarray(k[r:r + 1].numpy()),
                                 jnp.asarray(v[r:r + 1].numpy()), valid)
        _close(rows[r:r + 1], want)


@pytest.mark.parametrize("shape,window", [((1, 40, 4, 2, 32), 7),
                                          ((2, 33, 2, 2, 64), 16),
                                          ((1, 24, 4, 1, 32), 40)])
def test_plain_windowed_backward_matches_reference_vjp(shape, window):
    b, s, h, kv, d = shape
    q, k, v = _qkv(40, b, s, h, kv, d)
    do = _rand(44, b, s, h, d)

    def f(a, bb, c, g):
        out, vjp = jax.vjp(lambda x, y, z: JL.naive_attention(
            x, y, z, causal=True, window=window), a, bb, c)
        return (out, *vjp(g))
    want = jax.jit(f)(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window,
                                     return_lse=True)
    _close(o, want[0])
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=True,
                                      window=window)
    for g, w in zip(got, want[1:]):
        _close(g, w)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ref.flash_attention_ref(*leaves, causal=True, window=window)
    for g, w in zip(torch.autograd.grad(out, leaves, tdo), want[1:]):
        _close(g, w)
