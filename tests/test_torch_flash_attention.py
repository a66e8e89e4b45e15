"""K2's plain path (``repro_torch.kernels.ops.flash_attention`` on CPU
tensors) against the reference's attention oracles, and — on a machine
with a card — the CUDA kernel against its plain version.

Tolerances: fp32 1e-5 (the same math summed in another order), bf16
2e-2 (inputs rounded identically in both frameworks; outputs rounded to
bf16 at the end, ~8 bits of mantissa)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the card's kernel against its plain version on the card: fp32 sums of up
# to 1024 products taken in another order (and with expf on the card)
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _qkv(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    return q, k, v


@pytest.fixture(scope="module")
def jref():
    """The reference's attention oracles (the card's machine has no JAX:
    only the CPU parity tests need it)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.ref import flash_attention_ref
    from repro.models.layers import scan_attention

    # compiled whole: one XLA compile per shape instead of one per op
    return (jax.jit(flash_attention_ref, static_argnames=("causal",)),
            jax.jit(scan_attention, static_argnames=(
                "causal", "q_offset", "kv_len", "window", "scale", "block")))


def _both(arrs, dtype):
    import jax.numpy as jnp

    jt = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jt, tt


def _close(out_t, out_j, dtype):
    import jax.numpy as jnp

    got = out_t.detach().float().numpy()
    want = np.asarray(jnp.asarray(out_j).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


# (b, sq, sk, h, kv, d): ragged lengths, GQA, both head dims
SHAPES = [
    (2, 16, 16, 4, 4, 32),
    (1, 13, 29, 4, 2, 64),
    (2, 1, 37, 8, 2, 32),
    (1, 70, 70, 2, 1, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference_scan(jref, shape, causal, dtype):
    """q_offset form (query i at q_offset + i), kv_len bound, GQA by
    index: the port's CPU path against the reference's scan twin."""
    b, sq, sk, h, kv, d = shape
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, *shape), dtype)
    q_offset = sk - sq
    kv_len = sk - 3 if sk > 8 else sk
    want = jref[1](jq, jk, jv, causal=causal, q_offset=q_offset,
                    kv_len=kv_len, block=16)
    got = ops.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                              kv_len=kv_len)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_matches_reference_oracle_bottom_right(jref, d, dtype):
    """``ref.flash_attention_ref`` aligns causality bottom-right (equal
    heads): the port expresses that as q_offset = Sk - Sq."""
    shape = (2, 12, 20, 4, 4, d)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, *shape), dtype)
    want = jref[0](jq, jk, jv, causal=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=20 - 12)
    _close(got, want, dtype)


def test_plain_window_and_scale_match_reference_scan(jref):
    shape = (1, 24, 24, 4, 2, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, *shape), "float32")
    want = jref[1](jq, jk, jv, causal=True, window=5, scale=0.3, block=8)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=5, scale=0.3)
    _close(got, want, "float32")


def test_cpu_tensors_never_reach_the_kernel():
    fa.launches = 0
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 4, 2, 2, 32))
    ops.flash_attention(q, k, v)
    assert fa.launches == 0
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa.flash_attention_cuda(q, k, v)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


KERNEL_CASES = [
    # prefill shapes (slice: B=2, S=512/500, H=16, D=128), GQA, D=32
    dict(shape=(2, 512, 512, 16, 16, 128), causal=True, q_offset=0),
    dict(shape=(2, 500, 500, 16, 16, 128), causal=True, q_offset=0),
    dict(shape=(2, 300, 300, 16, 8, 128), causal=True, q_offset=0),
    dict(shape=(2, 77, 77, 4, 4, 32), causal=False, q_offset=0),
    dict(shape=(1, 96, 96, 4, 2, 64), causal=True, q_offset=0, window=40),
    # decode shapes: B=4, one query, a 1024-slot cache
    dict(shape=(4, 1, 1024, 16, 16, 128), causal=True, q_offset=0, kv_len=1),
    dict(shape=(4, 1, 1024, 16, 16, 128), causal=True, q_offset=36,
         kv_len=37),
    dict(shape=(4, 1, 1024, 16, 16, 128), causal=True, q_offset=1023,
         kv_len=1024),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: "x".join(map(str, c["shape"])))
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    case = dict(case)
    shape = case.pop("shape")
    tq, tk, tv = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                  for a in _qkv(4, *shape))
    before = fa.launches
    got = fa.flash_attention_cuda(tq, tk, tv, **case)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = flash_attention_ref(tq, tk, tv, **case)
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= KERNEL_TOL[dtype], err


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 4, 2, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 4, 2, 32), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 2, 4, 32), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q, q, q)


# ---------------------------------------------------------------------------
# the backward: K2's gradient
# ---------------------------------------------------------------------------

# (b, s, h, kv, d): ragged lengths, GQA, every head dim
BWD_SHAPES = [
    (2, 16, 4, 4, 32),
    (1, 29, 4, 2, 64),
    (1, 37, 2, 1, 128),
]


@pytest.fixture(scope="module")
def jvjp():
    """``jax.vjp`` of the reference's attention cores (causal,
    q_offset 0), compiled whole: (out, dq, dk, dv)."""
    jax = pytest.importorskip("jax")
    from repro.models.layers import naive_attention, scan_attention

    def make(fn, **kw):
        def f(q, k, v, do):
            out, vjp = jax.vjp(
                lambda a, b, c: fn(a, b, c, causal=True, **kw), q, k, v)
            return (out, *vjp(do))
        return jax.jit(f)

    return {"naive": make(naive_attention),
            "scan": make(scan_attention, block=16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "scan"])
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_reference_vjp(jvjp, shape, impl, dtype):
    """``flash_attention_bwd_ref`` (the explicit formulas, native GQA)
    and autograd through the CPU path both equal ``jax.vjp`` of the
    reference's attention."""
    b, s, h, kv, d = shape
    q, k, v = _qkv(5, b, s, s, h, kv, d)
    do = np.random.default_rng(6).standard_normal((b, s, h, d)).astype(
        np.float32)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both((q, k, v, do), dtype)
    want = jvjp[impl](jq, jk, jv, jdo)
    o, lse = flash_attention_ref(tq, tk, tv, causal=True, return_lse=True)
    got = fa.plain_bwd(tq, tk, tv, o, lse, tdo, causal=True)
    for g, w, t in zip(got, want[1:], (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, dtype)
    leaves = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=True)
    _close(out, want[0], dtype)
    for g, w in zip(torch.autograd.grad(out, leaves, tdo), want[1:]):
        _close(g, w, dtype)


def test_backward_lse_is_the_forward_log_sum_exp(jref):
    """The lse the backward reads: log-sum-exp of the scaled, masked
    scores, checked against the reference's oracle output through it."""
    shape = (1, 9, 9, 2, 2, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7, *shape), "float32")
    out, lse = flash_attention_ref(tq, tk, tv, causal=True, return_lse=True)
    assert lse.shape == (1, 2, 9) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / math.sqrt(32)
    p = torch.exp(s - lse[..., None]).tril()
    _close(torch.einsum("bhqk,bkhd->bqhd", p, tv), jref[0](jq, jk, jv),
           "float32")


KERNEL_BWD_CASES = [
    # the training shape's pattern at a smaller batch, GQA, D=64 and 32,
    # ragged S, and no mask
    dict(shape=(2, 1024, 16, 16, 128), causal=True),
    dict(shape=(2, 300, 16, 8, 128), causal=True),
    dict(shape=(2, 256, 8, 8, 64), causal=True),
    dict(shape=(1, 1000, 4, 4, 128), causal=True),
    dict(shape=(2, 77, 4, 2, 32), causal=False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_BWD_CASES,
                         ids=lambda c: "x".join(map(str, c["shape"])))
def test_autograd_function_matches_plain_backward_on_card(cuda_device, case,
                                                          dtype):
    b, s, h, kv, d = case["shape"]
    causal = case["causal"]
    tq, tk, tv = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                  for a in _qkv(8, b, s, s, h, kv, d))
    do = torch.randn((b, s, h, d), device=cuda_device).to(tq.dtype)
    leaves = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    f0, b0 = fa.launches, fa.bwd_launches
    out = ops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.launches - f0, fa.bwd_launches - b0) == (1, 1)
    o, lse = flash_attention_ref(tq, tk, tv, causal=causal, return_lse=True)
    want = fa.plain_bwd(tq, tk, tv, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        scale = max(w.float().abs().max().item(), 1.0)
        assert math.isfinite(err) and err <= KERNEL_TOL[dtype] * scale, err


@pytest.mark.gpu
def test_gradient_masks_without_a_kernel_raise(cuda_device):
    q = torch.zeros((1, 8, 2, 32), device=cuda_device, requires_grad=True)
    k = torch.zeros((1, 8, 2, 32), device=cuda_device)
    for kw in (dict(window=4), dict(kv_len=5), dict(q_offset=3)):
        with pytest.raises(ValueError, match="backward"):
            ops.flash_attention(q, k, k, causal=True, **kw)
    # without a gradient the forward alone runs, and saves no lse
    f0, b0 = fa.launches, fa.bwd_launches
    with torch.no_grad():
        ops.flash_attention(q, k, k, causal=True, kv_len=5)
    assert (fa.launches - f0, fa.bwd_launches - b0) == (1, 0)
