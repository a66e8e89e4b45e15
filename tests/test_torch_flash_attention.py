"""K2's plain path (``repro_torch.kernels.ops.flash_attention`` on CPU
tensors) against the reference's attention oracles, and — on a machine
with a card — the CUDA kernel against its plain version.

Tolerances: fp32 1e-5 (the same math summed in another order), bf16
2e-2 (inputs rounded identically in both frameworks; outputs rounded to
bf16 at the end, ~8 bits of mantissa)."""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.ref import flash_attention_splitkv_ref  # noqa: E402
from repro_torch.kernels.ref import tf32_matmul, tf32_round  # noqa: E402

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


# (b, sq, sk, h, kv, d): ragged lengths, GQA, the head dims of the
# configs (gpt2-paper-4b: 144 at full size, 36 in its smoke config)
SHAPES = [
    (2, 16, 16, 4, 4, 32),
    (1, 13, 29, 4, 2, 64),
    (2, 1, 37, 8, 2, 32),
    (1, 70, 70, 2, 1, 64),
    (1, 21, 21, 4, 4, 36),
    (1, 19, 33, 2, 2, 144),
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
@pytest.mark.parametrize("d", [32, 64, 96, 144, 192])
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


# ---------------------------------------------------------------------------
# the forward's schedules (plan_forward) and the split-kv arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_sends_decode_to_splitkv_in_both_dtypes(dtype):
    for sq in (1, fa.SPLITKV_MAX_SQ):
        plan = fa.plan_forward(4, sq, 1024, 16, dtype, kv_len=1024,
                               q_offset=1024 - sq)
        assert plan.schedule == "splitkv"
        assert plan.splits >= 1 and plan.split_rows % fa.SPLIT_GRAIN == 0


@pytest.mark.parametrize("shape", [(2, 512, 512, 16, 16, 128),
                                   (8, 1024, 1024, 16, 16, 128),
                                   (2, 77, 77, 4, 4, 32),
                                   (2, 16, 16, 4, 2, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_sends_bf16_to_tc_and_fp32_to_tf32x3(shape):
    b, sq, sk, h, kv, d = shape
    tc = fa.plan_forward(b, sq, sk, h, torch.bfloat16)
    assert tc == fa.ForwardPlan("tc")
    x3 = fa.plan_forward(b, sq, sk, h, "float32")
    assert x3 == fa.ForwardPlan("tf32x3")


def test_the_kernel_takes_the_head_dims_of_the_configs_on_the_card():
    """K2 takes every head dim of the configs that run on the card at full
    size (phi-3-vision's 96, gpt2-paper-4b's 144 and nemotron-4-340b's 192
    among them); a dim no config has (the smoke configs' 36 and 48, 80,
    256) raises in the wrapper's check before any launch."""
    from repro_torch.configs import ARCH_IDS, get_config

    # xlstm-1.3b runs no attention: its head_dim (512) is never read
    attn = [get_config(a) for a in ARCH_IDS]
    assert {c.head_dim for c in attn if c.arch_type != "ssm"} <= \
        set(fa.HEAD_DIMS)
    assert {96, 144, 192} <= set(fa.HEAD_DIMS)
    for d in (36, 48, 80, 256):
        assert d not in fa.HEAD_DIMS
    # MLA's q/k 192 with values 128 (deepseek-v2-lite) and nemotron's 192
    assert (192, 128) in fa.HEAD_PAIRS and (192, 192) in fa.HEAD_PAIRS


@pytest.mark.parametrize("dtype,schedule", [(torch.bfloat16, "tc"),
                                            (torch.float32, "tf32x3")])
def test_plan_at_the_nemotron_shapes(dtype, schedule):
    """nemotron-4-340b (96 heads of 192, 8 kv heads): (192, 192) is no
    pair of two head dims, so its decode takes the split kv, as every
    (d, d) does, where MLA's (192, 128) takes the 128-row schedule at any
    Sq; training and prefill take the dtype's tensor-core schedule."""
    dims = (192, 192)
    assert fa.plan_forward(1, 4096, 4096, 96, dtype, head_dims=dims) \
        == fa.ForwardPlan(schedule)
    assert fa.plan_forward(2, 512, 1024, 96, dtype, kv_len=512,
                           head_dims=dims) == fa.ForwardPlan(schedule)
    assert fa.plan_backward(dtype) == schedule
    plan = fa.plan_forward(4, 1, 1024, 96, dtype, kv_len=1024,
                           q_offset=1023, head_dims=dims)
    assert plan.schedule == "splitkv" and plan.split_rows % 64 == 0
    assert plan.splits * plan.split_rows >= 1024
    assert fa.plan_forward(4, 1, 1024, 96, dtype, kv_len=1024,
                           q_offset=1023, head_dims=(192, 128)) \
        == fa.ForwardPlan(schedule)


@pytest.mark.parametrize("dtype,schedule", [(torch.bfloat16, "tc"),
                                            (torch.float32, "tf32x3")])
def test_plan_at_the_4b_shapes(dtype, schedule):
    """gpt2-paper-4b (16 heads x 144): training and prefill take the
    dtype's tensor-core schedule, decode the split kv, forward and
    backward alike; the decode plan holds whole 64-row splits."""
    assert fa.plan_forward(8, 1024, 1024, 16, dtype) \
        == fa.ForwardPlan(schedule)
    assert fa.plan_forward(2, 512, 1024, 16, dtype, kv_len=512) \
        == fa.ForwardPlan(schedule)
    assert fa.plan_backward(dtype) == schedule
    plan = fa.plan_forward(4, 1, 1024, 16, dtype, kv_len=1024,
                           q_offset=1023)
    assert plan.schedule == "splitkv" and plan.split_rows % 64 == 0
    assert plan.splits * plan.split_rows >= 1024


def test_no_bf16_shape_reaches_an_fp32_schedule_and_no_fp32_shape_fma():
    for sq in (1, 2, 15, 16, 17, 127, 128, 129, 1024):
        for window in (None, 8):
            plan = fa.plan_forward(2, sq, 1024, 8, torch.bfloat16,
                                   q_offset=0, window=window)
            assert plan.schedule in ("tc", "splitkv")
            plan = fa.plan_forward(2, sq, 1024, 8, torch.float32,
                                   q_offset=0, window=window)
            assert plan.schedule == ("splitkv" if sq <= fa.SPLITKV_MAX_SQ
                                     else "tf32x3")
    # the FMA kernels are gone, forward and backward: every fp32 product
    # runs on the tensor cores in split TF32
    assert "fma" not in fa.SCHEDULES
    assert fa.plan_backward(torch.bfloat16) == "tc"
    assert fa.plan_backward("float32") == "tf32x3"
    assert fa.plan_backward(torch.float32) == "tf32x3"
    with pytest.raises(TypeError):
        fa.plan_forward(1, 4, 4, 1, torch.float16)
    with pytest.raises(TypeError):
        fa.plan_backward(torch.float16)


def _split_ranges(plan, hi):
    return [(plan.split_lo + s * plan.split_rows,
             min(plan.split_lo + (s + 1) * plan.split_rows, hi))
            for s in range(plan.splits)]


@pytest.mark.parametrize("kv_len", [1, 37, 64, 65, 1000, 1024])
def test_plan_makes_no_empty_split(kv_len):
    """The slice's decode shape: every split holds a key the query sees,
    the splits tile [0, kv_len) in whole 64-row tiles, and B*H*splits
    blocks fill the 132 SMs when the cache allows."""
    plan = fa.plan_forward(4, 1, 1024, 16, torch.bfloat16,
                           kv_len=kv_len, q_offset=kv_len - 1)
    assert plan.split_rows % fa.SPLIT_GRAIN == 0
    ranges = _split_ranges(plan, kv_len)
    assert ranges[0][0] == 0 and ranges[-1][1] == kv_len
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan.splits == math.ceil(kv_len / fa.SPLIT_GRAIN)
    if kv_len == 1024:
        assert plan.splits == 16 and 4 * 16 * plan.splits >= 4 * 132


def test_plan_splits_start_at_the_window():
    plan = fa.plan_forward(1, 1, 4096, 8, torch.float32,
                           kv_len=3000, q_offset=2999, window=500)
    assert plan.split_lo == (2999 - 500 + 1) // 64 * 64
    lo, hi = _split_ranges(plan, 3000)[0]
    assert lo <= 2500 < hi


SPLIT_CASES = [
    # (b, sq, sk, h, kv, d, q_offset, kv_len, window)
    (4, 1, 1024, 4, 4, 32, 0, 1, None),
    (2, 1, 1024, 4, 2, 32, 36, 37, None),
    (2, 1, 128, 4, 2, 64, 63, 64, None),
    (2, 1, 128, 4, 2, 64, 64, 65, None),
    (1, 1, 1024, 4, 1, 32, 999, 1000, None),
    (1, 1, 1024, 2, 2, 32, 1023, 1024, None),
    (1, 3, 300, 4, 2, 32, 200, 203, 90),
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_splitkv_arithmetic_matches_plain(case):
    """Per-split (m, l, acc) merged as the combine kernel merges them,
    with the plan's splits, equals the plain attention and its lse."""
    b, sq, sk, h, kv, d, q_offset, kv_len, window = case
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, b, sq, sk, h, kv, d))
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len, window=window)
    plan = fa.plan_forward(b, sq, sk, h, torch.float32, **kw)
    assert plan.schedule == "splitkv"
    got, lse = flash_attention_splitkv_ref(
        q, k, v, splits=plan.splits, split_lo=plan.split_lo,
        split_rows=plan.split_rows, return_lse=True, **kw)
    want, want_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("splits", [3, 5])
def test_splitkv_arithmetic_weighs_an_empty_split_zero(splits):
    """Splits wholly past kv_len (m = -1e30, l = 0) change nothing and
    give no NaN."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(10, 2, 1, 512, 4, 2, 64))
    kw = dict(causal=True, q_offset=64, kv_len=65)
    got, lse = flash_attention_splitkv_ref(q, k, v, splits=splits,
                                           split_lo=0, split_rows=64,
                                           return_lse=True, **kw)
    want, want_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_splitkv_arithmetic_matches_reference_scan(jref, dtype):
    """The split-kv arithmetic against the JAX package's scan attention
    on a decode step with GQA."""
    shape = (2, 1, 200, 8, 2, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(11, *shape), dtype)
    want = jref[1](jq, jk, jv, causal=True, q_offset=130, kv_len=131,
                    block=16)
    plan = fa.plan_forward(2, 1, 200, 8, getattr(torch, dtype),
                           kv_len=131, q_offset=130)
    got = flash_attention_splitkv_ref(
        tq, tk, tv, splits=plan.splits, split_lo=plan.split_lo,
        split_rows=plan.split_rows, causal=True, q_offset=130, kv_len=131)
    _close(got, want, dtype)


def test_library_path_covers_the_headers(tmp_path, monkeypatch):
    """An edited csrc header rebuilds every source; an unchanged tree
    keeps its library."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k.cu")
    assert build.library_path("k.cu") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = build.library_path("k.cu")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert build.library_path("k.cu") != second
    (tmp_path / "other.cuh").unlink()
    assert build.library_path("k.cu") == second


def _variants_tool():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "k2_fp32_variants.py"
    spec = importlib.util.spec_from_file_location("k2_fp32_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(_variants_tool().VARIANTS))
def test_fp32_variant_edits_apply_to_the_sources(name):
    """``tools/k2_fp32_variants.py`` builds its variants by text edits of
    the kernel sources: each edit must find its text exactly once, so a
    change to a kernel that breaks one shows here, not on the card."""
    tool = _variants_tool()
    texts = {f.name: f.read_text() for f in build.CSRC.iterdir()}
    for source, old, new in tool.VARIANTS[name]:
        assert texts[source].count(old) == 1, (source, old[:60])
        texts[source] = texts[source].replace(old, new)


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
    # prefill with kv_len < Sk, and a window in the tensor-core forward
    dict(shape=(2, 500, 512, 16, 16, 128), causal=True, q_offset=0,
         kv_len=480),
    dict(shape=(2, 512, 512, 16, 16, 128), causal=True, q_offset=0,
         window=128),
    # decode shapes: B=4, one query, a 1024-slot cache
    dict(shape=(4, 1, 1024, 16, 16, 128), causal=True, q_offset=0, kv_len=1),
    dict(shape=(4, 1, 1024, 16, 16, 128), causal=True, q_offset=36,
         kv_len=37),
    dict(shape=(4, 1, 1024, 16, 16, 128), causal=True, q_offset=1023,
         kv_len=1024),
    # decode: GQA, and kv_len at a split boundary and one past it
    dict(shape=(4, 1, 1024, 16, 8, 128), causal=True, q_offset=1023,
         kv_len=1024),
    dict(shape=(4, 1, 1024, 16, 16, 128), causal=True, q_offset=63,
         kv_len=64),
    dict(shape=(4, 1, 1024, 16, 16, 128), causal=True, q_offset=64,
         kv_len=65),
    # a few query rows: the split-kv kernel's rows past the first
    dict(shape=(1, 13, 29, 4, 2, 64), causal=True, q_offset=16, kv_len=26),
    # a long row: the accumulators' drift over 4096 keys
    dict(shape=(1, 4096, 4096, 16, 16, 128), causal=True, q_offset=0),
    # gpt2-paper-4b's head dim 144: prefill, ragged, decode; qwen2.5-3b's
    # GQA 8:1 in the decode
    dict(shape=(2, 1024, 1024, 16, 16, 144), causal=True, q_offset=0),
    dict(shape=(1, 300, 300, 4, 4, 144), causal=True, q_offset=0),
    dict(shape=(4, 1, 1024, 16, 16, 144), causal=True, q_offset=1023,
         kv_len=1024),
    dict(shape=(4, 1, 1024, 16, 16, 144), causal=True, q_offset=64,
         kv_len=65),
    dict(shape=(4, 1, 1024, 16, 2, 128), causal=True, q_offset=1023,
         kv_len=1024),
    # phi-3-vision's head dim 96: its patches and text, ragged, decode
    dict(shape=(2, 1024, 1024, 32, 32, 96), causal=True, q_offset=0),
    dict(shape=(1, 300, 300, 4, 4, 96), causal=True, q_offset=0),
    dict(shape=(4, 1, 1024, 32, 32, 96), causal=True, q_offset=1023,
         kv_len=1024),
    dict(shape=(4, 1, 1024, 32, 32, 96), causal=True, q_offset=64,
         kv_len=65),
    # nemotron-4-340b's head dim 192 at its GQA 12:1: prefill, ragged,
    # decode
    dict(shape=(2, 512, 512, 12, 1, 192), causal=True, q_offset=0),
    dict(shape=(1, 300, 300, 4, 4, 192), causal=True, q_offset=0),
    dict(shape=(4, 1, 1024, 12, 1, 192), causal=True, q_offset=1023,
         kv_len=1024),
    dict(shape=(4, 1, 1024, 12, 1, 192), causal=True, q_offset=64,
         kv_len=65),
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [c for c in KERNEL_CASES
                                  if c["shape"][1] <= fa.SPLITKV_MAX_SQ],
                         ids=lambda c: "x".join(map(str, c["shape"]))
                         + f"-kv{c.get('kv_len')}")
def test_splitkv_combine_matches_its_arithmetic_on_card(cuda_device, case,
                                                        dtype):
    """The split-kv kernel and its combine against the same splits
    merged in plain PyTorch, output and lse."""
    case = dict(case)
    shape = case.pop("shape")
    tq, tk, tv = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                  for a in _qkv(12, *shape))
    plan = fa.plan_forward(*shape[:4], tq.dtype, **case)
    assert plan.schedule == "splitkv"
    got, lse = fa.flash_attention_cuda(tq, tk, tv, return_lse=True, **case)
    want, want_lse = flash_attention_splitkv_ref(
        tq, tk, tv, splits=plan.splits, split_lo=plan.split_lo,
        split_rows=plan.split_rows, return_lse=True, **case)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= KERNEL_TOL[dtype], err
    assert (lse - want_lse).abs().max().item() <= 1e-4


# the fp32 forward against its own arithmetic: the same split products,
# summed in another order and in mma.sync's accumulator (see
# KERNEL_TF32_REL_TOL below)
KERNEL_TF32_FWD_REL_TOL = 5e-5


@pytest.mark.gpu
@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("case", [c for c in KERNEL_CASES
                                  if c["shape"][1] > fa.SPLITKV_MAX_SQ],
                         ids=lambda c: "x".join(map(str, c["shape"])))
def test_tf32x3_forward_matches_its_arithmetic_on_card(cuda_device, case,
                                                       return_lse):
    case = dict(case)
    shape = case.pop("shape")
    tq, tk, tv = (torch.from_numpy(a).to(cuda_device)
                  for a in _qkv(18, *shape))
    assert fa.plan_forward(*shape[:4], torch.float32, **case) \
        == fa.ForwardPlan("tf32x3")
    before = fa.launches
    got = fa.flash_attention_cuda(tq, tk, tv, return_lse=return_lse, **case)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want, want_lse = _tf32_fwd(tq, tk, tv, return_lse=True, **case)
    pairs = [(got[0], want), (got[1], want_lse)] if return_lse \
        else [(got, want)]
    for g, w in pairs:
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = (g - w).abs().max().item()
        assert math.isfinite(err)
        assert err <= KERNEL_TF32_FWD_REL_TOL * max(w.abs().max().item(), 1.0)
        assert ((g - w).norm() / w.norm()).item() <= KERNEL_TF32_FWD_REL_TOL


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda_device):
    for d in (36, 48, 256):
        q = torch.zeros((1, 4, 2, d), device=cuda_device)
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
    (1, 21, 2, 2, 144),
    (1, 45, 2, 2, 96),
    (1, 23, 3, 1, 192),
]


@pytest.fixture(scope="module")
def jvjp():
    """``jax.vjp`` of the reference's attention cores (causal,
    q_offset 0), compiled whole: (out, dq, dk, dv)."""
    jax = pytest.importorskip("jax")
    from repro.models.layers import naive_attention, scan_attention

    def make(fn, causal=True, **kw):
        def f(q, k, v, do):
            out, vjp = jax.vjp(
                lambda a, b, c: fn(a, b, c, causal=causal, **kw), q, k, v)
            return (out, *vjp(do))
        return jax.jit(f)

    return {"naive": make(naive_attention),
            "scan": make(scan_attention, block=16),
            "naive_unmasked": make(naive_attention, causal=False)}


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


def _rel(got, want):
    """Relative Frobenius error |got - want| / |want|, in fp32."""
    got, want = (t.float() if isinstance(t, torch.Tensor)
                 else torch.from_numpy(np.array(t, dtype=np.float32))
                 for t in (got, want))
    return ((got - want).norm() / want.norm()).item()


def test_tf32_round_is_round_to_nearest_ties_away():
    """``cvt.rna.tf32.f32``: 10 mantissa bits kept, a tie rounds away from
    zero, a TF32 value stays as it is, the sign is kept."""
    ulp = 2.0 ** -10  # of a TF32 mantissa at 1.0
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 2,
                      -(1 + ulp / 2), 1 + ulp, -7.5, 0.0])
    assert tf32_round(x).tolist() == [1.0, 1 + ulp, 1.0, 1 + 2 * ulp,
                                      -(1 + ulp), 1 + ulp, -7.5, 0.0]
    rng = np.random.default_rng(13)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    r = tf32_round(y)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    # within half a TF32 ulp of the input: |y - r| <= 2^-11 |r|
    assert ((y - r).abs() <= 2.0 ** -11 * r.abs()).all()
    assert torch.equal(tf32_round(r), r)


def test_split_tf32_product_is_near_fp32():
    """Three TF32 products hold ~2^-21 relative; one holds ~2^-11."""
    rng = np.random.default_rng(14)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float64))
            for s in ((64, 128), (128, 48)))
    want = a @ b
    three = tf32_matmul(a.float(), b.float()).double()
    one = tf32_matmul(a.float(), b.float(), terms=1).double()
    assert ((three - want).norm() / want.norm()).item() < 2e-6
    assert ((one - want).norm() / want.norm()).item() > 1e-4


def _tf32_fwd(q, k, v, *, terms=3, **kw):
    """The fp32 forward kernel's arithmetic: the plain forward with both
    products split into ``terms`` TF32 products."""
    return flash_attention_ref(
        q, k, v, matmul=functools.partial(tf32_matmul, terms=terms), **kw)


# (b, sq, sk, h, kv, d, options): ragged lengths, GQA, every head dim,
# kv_len < Sk, the q_offset form, windows, and no mask
TF32_FWD_CASES = [
    (2, 16, 16, 4, 4, 32, dict(causal=True)),
    (1, 29, 29, 4, 2, 64, dict(causal=True)),
    (1, 37, 37, 2, 1, 128, dict(causal=True)),
    (1, 20, 45, 4, 2, 64, dict(causal=True, q_offset=25, kv_len=42)),
    (1, 33, 33, 4, 2, 32, dict(causal=True, window=7)),
    (1, 18, 50, 2, 2, 128, dict(causal=True, q_offset=30, kv_len=47,
                                window=12)),
    (2, 23, 31, 4, 2, 32, dict(causal=False, kv_len=27)),
    (1, 27, 27, 2, 2, 144, dict(causal=True)),
    (1, 27, 27, 3, 1, 192, dict(causal=True)),
]


@pytest.mark.parametrize("case", TF32_FWD_CASES,
                         ids=lambda c: "x".join(map(str, c[:6])) + "-"
                         + "-".join(f"{k}{v}" for k, v in c[6].items()))
def test_tf32x3_forward_arithmetic_matches_reference_scan(jref, case):
    """The fp32 forward kernel's arithmetic (both products split into
    three TF32 products) against the JAX package's scan attention, within
    the fp32 tolerance (1e-5)."""
    b, sq, sk, h, kv, d, kw = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(17, b, sq, sk, h, kv, d),
                                       "float32")
    want = jref[1](jq, jk, jv, block=16, **kw)
    got, lse = _tf32_fwd(tq, tk, tv, return_lse=True, **kw)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    _close(got, want, "float32")
    _, plain_lse = flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_single_tf32_product_does_not_hold_the_fp32_forward_tolerance():
    """Why three products in the forward too: with one TF32 product each,
    S and P V miss the 1e-4 the fp32 parity phases hold the card to."""
    b, sq, sk, h, kv, d, kw = TF32_FWD_CASES[2]
    q, k, v = (torch.from_numpy(a) for a in _qkv(17, b, sq, sk, h, kv, d))
    plain = flash_attention_ref(q, k, v, **kw)
    one = _tf32_fwd(q, k, v, terms=1, **kw)
    three = _tf32_fwd(q, k, v, **kw)
    assert (one - plain).abs().max().item() > 1e-4
    assert _rel(one, plain) > 1e-4
    assert (three - plain).abs().max().item() <= 1e-5
    assert _rel(three, plain) <= 1e-5


# (b, s, h, kv, d, causal): GQA, ragged S with D=128, and D=32 unmasked
TF32_BWD_CASES = [
    (1, 29, 4, 2, 64, True),
    (1, 37, 2, 1, 128, True),
    (2, 23, 4, 2, 32, False),
    (1, 27, 2, 2, 144, True),
    (1, 27, 3, 1, 192, True),
]


def _tf32_bwd(q, k, v, o, lse, do, *, causal, terms=3):
    """The fp32 backward kernel's arithmetic: the plain backward with every
    product split into ``terms`` TF32 products."""
    return fa.plain_bwd(q, k, v, o, lse, do, causal=causal,
                        matmul=functools.partial(tf32_matmul, terms=terms))


def _bwd_inputs(seed, b, s, h, kv, d):
    q, k, v = _qkv(seed, b, s, s, h, kv, d)
    do = np.random.default_rng(seed + 1).standard_normal(
        (b, s, h, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", TF32_BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_tf32x3_backward_arithmetic_matches_plain_and_reference_vjp(jvjp,
                                                                    case):
    """The fp32 backward kernel's arithmetic (every product split into
    three TF32 products, in the kernel's order) against the plain
    backward and against ``jax.vjp`` of the reference's attention: within
    1e-5 relative Frobenius error for each of dq, dk and dv."""
    b, s, h, kv, d, causal = case
    q, k, v, do = _bwd_inputs(15, b, s, h, kv, d)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both((q, k, v, do), "float32")
    o, lse = flash_attention_ref(tq, tk, tv, causal=causal, return_lse=True)
    got = _tf32_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    plain = fa.plain_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    want = jvjp["naive" if causal else "naive_unmasked"](jq, jk, jv, jdo)
    for g, p_, w, t in zip(got, plain, want[1:], (tq, tk, tv)):
        assert g.dtype == torch.float32 and g.shape == t.shape
        assert _rel(g, p_) <= 1e-5
        assert _rel(g, w) <= 1e-5


def test_single_tf32_product_does_not_hold_the_fp32_tolerance():
    """Why three products: the same backward with one TF32 product each
    misses the 1e-4 the fp32 parity phases hold the card to."""
    b, s, h, kv, d, causal = TF32_BWD_CASES[0]
    q, k, v, do = (torch.from_numpy(a)
                   for a in _bwd_inputs(15, b, s, h, kv, d))
    o, lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    plain = fa.plain_bwd(q, k, v, o, lse, do, causal=causal)
    one = _tf32_bwd(q, k, v, o, lse, do, causal=causal, terms=1)
    three = _tf32_bwd(q, k, v, o, lse, do, causal=causal)
    assert max(_rel(g, w) for g, w in zip(one, plain)) > 1e-4
    assert max(_rel(g, w) for g, w in zip(three, plain)) <= 1e-5


KERNEL_BWD_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
KERNEL_BWD_CASES = [
    # the training shape's pattern at a smaller batch, GQA, D=64 and 32,
    # ragged S, and no mask
    dict(shape=(2, 1024, 16, 16, 128), causal=True),
    dict(shape=(2, 300, 16, 8, 128), causal=True),
    dict(shape=(2, 256, 8, 8, 64), causal=True),
    dict(shape=(1, 1000, 4, 4, 128), causal=True),
    dict(shape=(2, 77, 4, 2, 32), causal=False),
    # the training shape
    dict(shape=(8, 1024, 16, 16, 128), causal=True),
    # a long row: the accumulators' drift over 4096 rows
    dict(shape=(1, 4096, 16, 16, 128), causal=True),
    # gpt2-paper-4b's head dim 144: its attention, ragged, unmasked
    dict(shape=(2, 1024, 16, 16, 144), causal=True),
    dict(shape=(1, 300, 4, 4, 144), causal=True),
    dict(shape=(1, 77, 4, 2, 144), causal=False),
    # phi-3-vision's head dim 96: its attention, ragged, unmasked
    dict(shape=(2, 1024, 32, 32, 96), causal=True),
    dict(shape=(1, 300, 4, 4, 96), causal=True),
    dict(shape=(1, 77, 4, 2, 96), causal=False),
    # nemotron-4-340b's head dim 192 (dK and dV in two launches, the fp32
    # blocks at 64 rows): GQA 12:1, ragged, unmasked
    dict(shape=(1, 1024, 12, 1, 192), causal=True),
    dict(shape=(1, 300, 4, 4, 192), causal=True),
    dict(shape=(1, 77, 4, 2, 192), causal=False),
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
        # a dropped tile moves the relative Frobenius error, even where
        # the largest gradient makes the absolute tolerance loose
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= KERNEL_BWD_REL_TOL[dtype], rel


# the fp32 kernel against its own arithmetic, tighter than against the
# plain backward (1e-4): the same split products, summed in another order
# and in mma.sync's fp32 accumulator, which does not round to nearest and
# drifts linearly in the reduction's length; dK and dV, whose sums are the
# longest, take one truncation a k-step (tf32.cuh: mma3_rn) to stay within
# this over 4096 rows
KERNEL_TF32_REL_TOL = 5e-5


@pytest.mark.gpu
@pytest.mark.parametrize("case", KERNEL_BWD_CASES,
                         ids=lambda c: "x".join(map(str, c["shape"])))
def test_tf32x3_backward_matches_its_arithmetic_on_card(cuda_device, case):
    b, s, h, kv, d = case["shape"]
    causal = case["causal"]
    assert fa.plan_backward(torch.float32) == "tf32x3"
    tq, tk, tv, tdo = (torch.from_numpy(a).to(cuda_device)
                       for a in _bwd_inputs(16, b, s, h, kv, d))
    o, lse = fa.flash_attention_cuda(tq, tk, tv, causal=causal,
                                     return_lse=True)
    b0 = fa.bwd_launches
    got = fa.flash_attention_bwd_cuda(tq, tk, tv, o, lse, tdo, causal=causal)
    torch.cuda.synchronize()
    assert fa.bwd_launches == b0 + 1
    model = _tf32_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    for g, w in zip(got, model):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = (g - w).abs().max().item()
        assert math.isfinite(err)
        assert err <= KERNEL_TF32_REL_TOL * max(w.abs().max().item(), 1.0)
        assert ((g - w).norm() / w.norm()).item() <= KERNEL_TF32_REL_TOL


# (b, s, h, kv, causal) at MLA's head dims (192, 128): ragged, GQA,
# unmasked, and a prompt shorter than the split-kv bound (the 128-row
# kernels take it)
MLA_CASES = [(2, 77, 4, 4, True), (1, 130, 4, 2, True), (2, 65, 2, 2, False),
             (1, 7, 4, 4, True)]
# the same at nemotron-4-340b's (192, 192), its GQA 12:1 among them; the
# short prompt takes the split kv forward there
NEMOTRON_CASES = [(2, 77, 12, 1, True), (1, 130, 4, 2, True),
                  (2, 65, 2, 2, False), (1, 7, 12, 1, True)]


def _pair_matches_plain(cuda_device, case, dtype, dv):
    """K2 at q/k head dim 192 and value head dim ``dv``: the forward with
    its lse and the autograd function's gradients against the plain
    version, with the head dim's scale; each launch counted under its
    pair."""
    b, s, h, kv, causal = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k = (torch.randn(shape, generator=g, device=cuda_device).to(dt)
            for shape in ((b, s, h, 192), (b, s, kv, 192)))
    v = torch.randn((b, s, kv, dv), generator=g, device=cuda_device).to(dt)
    do = torch.randn((b, s, h, dv), generator=g, device=cuda_device).to(dt)
    kw = dict(causal=causal, scale=1 / math.sqrt(192))
    f0 = fa.pair_launches[(192, dv)]
    b0 = fa.bwd_pair_launches[(192, dv)]
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, do)
    torch.cuda.synchronize()
    assert o.shape == (b, s, h, dv)
    assert (fa.pair_launches[(192, dv)] - f0,
            fa.bwd_pair_launches[(192, dv)] - b0) == (2, 1)
    o_ref, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert (o.float() - o_ref.float()).abs().max().item() <= \
        KERNEL_TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    want = fa.plain_bwd(q, k, v, o_ref, lse_ref, do, **kw)
    for gr, w in zip(got, want):
        assert gr.dtype == w.dtype and gr.shape == w.shape
        err = (gr.float() - w.float()).abs().max().item()
        assert err <= KERNEL_TOL[dtype] * max(w.float().abs().max().item(),
                                              1.0), err
        rel = ((gr.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= KERNEL_BWD_REL_TOL[dtype], rel


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLA_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_mla_head_dims_match_plain_on_card(cuda_device, case, dtype):
    """K2 at MLA's (192, 128) against the plain version
    (:func:`_pair_matches_plain`)."""
    _pair_matches_plain(cuda_device, case, dtype, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", NEMOTRON_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_nemotron_head_dims_match_plain_on_card(cuda_device, case, dtype):
    """K2 at nemotron-4-340b's (192, 192) against the plain version
    (:func:`_pair_matches_plain`): both dtypes' dK/dV in two launches."""
    _pair_matches_plain(cuda_device, case, dtype, 192)


@pytest.mark.gpu
def test_head_dim_pairs_without_a_kernel_raise_on_card(cuda_device):
    """Only (d, d) and (192, 128) reach a kernel; the pair takes no
    per-row ``kv_lens`` (the split-kv schedule has no such pair)."""
    for d, dv in ((128, 64), (192, 64), (64, 128)):
        q = torch.zeros((1, 4, 2, d), device=cuda_device)
        v = torch.zeros((1, 4, 2, dv), device=cuda_device)
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_attention_cuda(q, q, v)
    q = torch.zeros((2, 1, 2, 192), device=cuda_device)
    v = torch.zeros((2, 8, 2, 128), device=cuda_device)
    k = torch.zeros((2, 8, 2, 192), device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="kv_lens"):
        fa.flash_attention_cuda(q, k, v, causal=False, kv_lens=lens)


@pytest.mark.gpu
def test_gradient_masks_without_a_kernel_raise(cuda_device):
    q = torch.zeros((1, 8, 2, 32), device=cuda_device, requires_grad=True)
    k = torch.zeros((1, 8, 2, 32), device=cuda_device)
    for kw in (dict(kv_len=5), dict(q_offset=3)):
        with pytest.raises(ValueError, match="backward"):
            ops.flash_attention(q, k, k, causal=True, **kw)
    # without a gradient the forward alone runs, and saves no lse
    f0, b0 = fa.launches, fa.bwd_launches
    with torch.no_grad():
        ops.flash_attention(q, k, k, causal=True, kv_len=5)
    assert (fa.launches - f0, fa.bwd_launches - b0) == (1, 0)


# (b, s, h, kv, d, window): windows that cut inside a tile, on a tile edge
# (64 and 128 rows: the bf16 kernels' kv tile and block, 32 and 128 the
# fp32 kernels'), and not at all (window >= S); GQA 2:1 and 4:1
WINDOW_BWD_CASES = [
    (1, 300, 4, 2, 128, 100),
    (2, 256, 4, 4, 32, 64),
    (1, 512, 8, 2, 128, 128),
    (1, 200, 4, 1, 32, 37),
    (1, 1024, 8, 2, 128, 512),
    (2, 160, 4, 2, 128, 160),
    (1, 96, 4, 2, 32, 300),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WINDOW_BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_windowed_backward_matches_plain_on_card(cuda_device, case, dtype):
    """K2's windowed backward, both schedules, through the autograd route,
    against the plain backward fed the plain forward's o and lse."""
    b, s, h, kv, d, window = case
    tq, tk, tv = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                  for a in _qkv(9, b, s, s, h, kv, d))
    do = torch.randn((b, s, h, d), device=cuda_device).to(tq.dtype)
    leaves = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    f0, b0 = fa.launches, fa.bwd_launches
    out = ops.flash_attention(*leaves, causal=True, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.launches - f0, fa.bwd_launches - b0) == (1, 1)
    o, lse = flash_attention_ref(tq, tk, tv, causal=True, window=window,
                                 return_lse=True)
    want = fa.plain_bwd(tq, tk, tv, o, lse, do, causal=True, window=window)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        scale = max(w.float().abs().max().item(), 1.0)
        assert math.isfinite(err) and err <= KERNEL_TOL[dtype] * scale, err
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= KERNEL_BWD_REL_TOL[dtype], rel


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_not_shorter_than_the_sequence_is_bit_identical(cuda_device,
                                                               dtype):
    """A window >= S masks nothing: forward and backward equal the
    unwindowed kernels bit for bit."""
    b, s, h, kv, d = 1, 200, 4, 2, 128
    tq, tk, tv, tdo = (torch.from_numpy(a).to(cuda_device,
                                              getattr(torch, dtype))
                       for a in _bwd_inputs(21, b, s, h, kv, d))
    runs = []
    for window in (None, s, 4 * s):
        o, lse = fa.flash_attention_cuda(tq, tk, tv, causal=True,
                                         window=window, return_lse=True)
        grads = fa.flash_attention_bwd_cuda(tq, tk, tv, o, lse, tdo,
                                            causal=True, window=window)
        runs.append((o, lse) + tuple(grads))
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b_ in zip(runs[0], other):
            assert torch.equal(a, b_)
