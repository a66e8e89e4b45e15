"""K1 (fused chunked ADAM): the port's plain version and its CPU entry
point (``ops.chunked_adam`` on CPU tensors) against the reference's
Pallas kernel in interpret mode and its oracle, on the sweep of
``tests/test_kernels.py::test_chunked_adam_sweep``; and — on a machine
with a card — the Triton kernel against its plain version.

Tolerances: 1e-6 on p, m and v (the reference's own; fp32 math, the
hyperparameters rounded to fp32 once); the bf16 param output within 1e-6
plus one bf16 unit in the last place of the updated fp32 params: it is
their rounding to bf16, give or take the fp32 tolerance, which may move a
value that cancels to near zero by several of its ulps."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import chunked_adam as ka  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import adam_ref  # noqa: E402

TOL = 1e-6
HP = dict(lr=3e-3, beta1=0.9, beta2=0.95, eps=1e-8, bias_corr1=0.1,
          bias_corr2=0.05)


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 0.01).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    return p, m, v, g


@pytest.fixture(scope="module")
def jref():
    """The reference's Pallas kernel (interpret mode) and its oracle."""
    pytest.importorskip("jax")
    from repro.kernels import ref
    from repro.kernels.chunked_adam import BLOCK, chunked_adam_kernel

    return BLOCK, chunked_adam_kernel, ref.adam_ref


def _bf16_ulp(x):
    """One bf16 unit in the last place at each element of fp32 ``x``."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def _assert_out(out, want_p):
    """The fused output against the updated fp32 params ``want_p``: 1e-6
    in fp32; in bf16, 1e-6 plus one bf16 ulp of ``want_p``.  An output
    that kept the old params is off by lr |update|, several ulps wherever
    |p| is small."""
    tol = TOL + (TOL * want_p.abs() if out.dtype == torch.float32
                 else _bf16_ulp(want_p))
    err = (out.float() - want_p).abs()
    assert bool((err <= tol).all()), err.max().item()


def _close(got, want, tol=TOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=err_msg)


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_plain_and_cpu_entry_match_reference_kernel(jref, n_blocks, gdtype,
                                                    wd):
    import jax.numpy as jnp

    block, kernel, oracle = jref
    n = block * n_blocks
    p, m, v, g = _inputs(0, n)
    hp = dict(HP, weight_decay=wd)
    jg = jnp.asarray(g).astype(getattr(jnp, gdtype))
    jargs = (jnp.asarray(p), jnp.asarray(m), jnp.asarray(v), jg)
    jdt = getattr(jnp, gdtype)
    want = kernel(*jargs, interpret=True, param_dtype=jdt, **hp)
    want_oracle = oracle(*jargs, **hp)
    tg = torch.from_numpy(g).to(getattr(torch, gdtype))
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    plain = adam_ref(tp, tm, tv, tg, **hp)
    for a, b, c, name in zip(plain, want[:3], want_oracle, "pmv"):
        _close(a, b, err_msg=name)
        _close(a, c, err_msg=name)
    # the CPU entry point: in place, plus the fused param-dtype output
    out = torch.empty(n, dtype=getattr(torch, gdtype))
    ops.chunked_adam(tp, tm, tv, tg, out=out, **hp)
    for a, b, name in zip((tp, tm, tv), want[:3], "pmv"):
        _close(a, b, err_msg=name)
    _assert_out(out, torch.tensor(np.asarray(want[0])))


def test_ragged_length_matches_padded_reference_kernel(jref):
    """Chunk payloads are not multiples of the kernel block: the port
    masks the tail where the reference pads upstream."""
    import jax.numpy as jnp

    block, kernel, _ = jref
    n = block + 1234
    pad = (-n) % block
    p, m, v, g = _inputs(1, n)
    hp = dict(HP, weight_decay=0.1)
    jp = [jnp.pad(jnp.asarray(a), (0, pad)) for a in (p, m, v, g)]
    want = kernel(*jp, interpret=True, param_dtype=jnp.float32, **hp)
    tp, tm, tv, tg = (torch.from_numpy(a.copy()) for a in (p, m, v, g))
    # g aliased to the output, as the engine's grad-reuse payload is
    ops.chunked_adam(tp, tm, tv, tg, out=tg, **hp)
    for a, b, name in zip((tp, tm, tv, tg), want, "pmvo"):
        _close(a, np.asarray(b)[:n], err_msg=name)


def test_cpu_tensors_never_reach_the_kernel():
    ka.launches = 0
    p, m, v, g = (torch.from_numpy(a) for a in _inputs(2, 100))
    ops.chunked_adam(p, m, v, g, out=g, weight_decay=0.0, **HP)
    assert ka.launches == 0
    with pytest.raises(ValueError, match="not a CUDA device"):
        ka.chunked_adam_triton(p, m, v, g, g, weight_decay=0.0, **HP)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Triton kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (n, g dtype, out dtype, wd, out aliases g)
    (1 << 20, "float32", "float32", 0.0, True),   # the engine's path
    (1 << 20, "bfloat16", "bfloat16", 0.1, False),
    (1_000_003, "float32", "float32", 0.1, False),  # ragged tail
    (1_000_003, "bfloat16", "bfloat16", 0.0, True),
], ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_on_card(cuda_device, case):
    n, gdt, odt, wd, alias = case
    p, m, v, g = (torch.from_numpy(a).to(cuda_device)
                  for a in _inputs(3, n))
    g = g.to(getattr(torch, gdt))
    hp = dict(HP, weight_decay=wd)
    want = adam_ref(p, m, v, g, **hp)
    out = g if alias else torch.empty(n, dtype=getattr(torch, odt),
                                      device=cuda_device)
    before = ka.launches
    ka.chunked_adam_triton(p, m, v, g, out, **hp)
    torch.cuda.synchronize()
    assert ka.launches == before + 1
    for a, b in zip((p, m, v), want):
        err = (a - b).abs().max().item()
        assert math.isfinite(err) and err <= TOL, err
    _assert_out(out, want[0])


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda_device):
    p = torch.zeros(64, device=cuda_device)
    with pytest.raises(TypeError):
        ka.chunked_adam_triton(p.double(), p.clone(), p.clone(), p.clone(),
                               p.clone(), weight_decay=0.0, **HP)
    with pytest.raises(ValueError, match="elements"):
        ka.chunked_adam_triton(p, p.clone(), p.clone(), p[:32], p.clone(),
                               weight_decay=0.0, **HP)
    with pytest.raises(ValueError, match="share memory"):
        ka.chunked_adam_triton(p, p, p.clone(), p.clone(), p.clone(),
                               weight_decay=0.0, **HP)
