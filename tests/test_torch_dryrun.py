"""The port's dry-run (``repro_torch.launch.dryrun``) and the analysis
under it, on the CPU.

* ``count_params`` and ``model_flops`` of every config of the registry at
  full width, at tp 1 and on the smoke mesh 2 x 2, for every input shape,
  equal the reference's (``repro.analysis.roofline`` on a runtime built as
  ``tests/test_archs.py`` builds its own); so do ``INPUT_SHAPES``,
  ``supported_shapes()`` and ``supports_decode``;
* on the meta device at smoke size and the 2 x 2 mesh, a step's FLOPs
  outside attention and its K1 and K2 calls equal those of the same step
  run on CPU tensors under ``FlopCounterMode`` (attention counted as the
  card's K2 calls and kept out of the count); each meta K2 call adds the
  work formula ``chip_smoke.py``'s bound column uses; a train step's
  collectives hold the chunk all-gather and reduce-scatter (the twin of
  ``tests/test_substrate.py::test_train_hlo_has_chunked_collectives``);
  one data rank's trace agrees with the full trace;
* zamba's and xlstm's train steps at tp 2 report ``tp_psum_bytes`` above
  the cost model's ``tp_bytes`` by exactly the gated norms' psums
  (B x S x 4 bytes over the ring, a layer and a pass), which the counter
  saw as they ran.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.configs.base import INPUT_SHAPES as REF_SHAPES  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jax_mesh  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro.runtime.step import RuntimeOptions as JaxOptions  # noqa: E402
from torch.utils._python_dispatch import (  # noqa: E402
    _disable_current_modes,
)
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, model_class  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_production_mesh,
    make_smoke_mesh,
)
from repro_torch.models import layers  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

MESHES = [(1, 1), (2, 2)]
# the smoke step: os_host_fraction 0.5 so the host parts travel, and the
# plain ADAM routed through K1's entry on the CPU, as the card runs it
OPTIONS = RuntimeOptions(os_host_fraction=0.5, weight_decay=0.1,
                         use_adam_kernel=True)


def _runtimes(arch, dp, tp, smoke=False):
    jcfg, cfg = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(dp, tp),
                     JaxOptions())
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(dp, tp, device="meta"),
                        RuntimeOptions())
    return jrt, rt


def test_input_shapes_and_production_mesh_are_the_reference_s():
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape) == (("data", "model"),
                                           {"data": 16, "model": 16})
    assert (two.axis_names, two.shape) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
    assert one.device.type == two.device.type == "meta"


@pytest.mark.parametrize("dp,tp", MESHES, ids=["tp1", "dp2_tp2"])
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_count_params_and_model_flops_equal_the_reference_s(arch, dp, tp):
    jrt, rt = _runtimes(arch, dp, tp)
    want = ref_roofline.count_params(jrt)
    got = roofline.count_params(rt)
    assert got == want
    for name, shape in INPUT_SHAPES.items():
        assert roofline.model_flops(rt, shape, *got) == \
            ref_roofline.model_flops(jrt, REF_SHAPES[name], *want), name
    assert rt.cfg.supported_shapes() == jrt.cfg.supported_shapes()
    assert rt.model.supports_decode == jrt.model.supports_decode


# ------------------------------------------------ the meta trace vs the CPU
class _CountedAttention(torch.autograd.Function):
    """The CPU's attention counted as the card's K2 calls, its products
    kept out of the outer FLOP count (every dispatch mode off inside)."""

    calls = {"fwd": 0, "bwd": 0}

    @staticmethod
    def forward(ctx, q, k, v, kw):
        _CountedAttention.calls["fwd"] += 1
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        with _disable_current_modes(), torch.no_grad():
            return flash_attention_ref(q, k, v, **kw)

    @staticmethod
    def backward(ctx, do):
        _CountedAttention.calls["bwd"] += 1
        q, k, v = ctx.saved_tensors
        with _disable_current_modes(), torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_ref(*leaves, **ctx.kw)
            grads = torch.autograd.grad(out, leaves, do)
        return (*grads, None)


def _cpu_attention(q, k, v, ctx, **kw):
    return _CountedAttention.apply(q, k, v, kw)


def _cpu_decode_attend(q, k, v, pos):
    c = k.shape[1]
    return _CountedAttention.apply(q, k, v, dict(
        causal=True, q_offset=pos, kv_len=min(pos + 1, c)))


def _smoke(arch, shape_kind):
    cfg = get_config(arch, smoke=True)
    s = 32 + (cfg.num_patches if cfg.arch_type == "vlm" else 0)
    return cfg, InputShape("smoke", s, 2, shape_kind)


def _cpu_counts(arch, kind, monkeypatch):
    """The step on CPU tensors: FlopCounterMode's FLOPs outside attention,
    K2's forward and backward calls, K1's calls."""
    cfg, shape = _smoke(arch, kind)
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(2, 2, device="cpu"), OPTIONS)
    k1 = []
    real_adam = ops.chunked_adam
    monkeypatch.setattr(layers, "attention_core", _cpu_attention)
    monkeypatch.setattr(layers, "_decode_attend", _cpu_decode_attend)
    monkeypatch.setattr(ops, "chunked_adam", lambda *a, **kw: (
        k1.append(1), real_adam(*a, **kw))[1])
    _CountedAttention.calls.update(fwd=0, bwd=0)
    ps, os_ = driver.init_state(rt, 0)
    gen = np.random.default_rng(0)
    fc = FlopCounterMode(display=False)
    if kind == "train":
        step, args, _ = driver.build_train_step(rt, shape)
        batch = {k: gen.integers(0, cfg.vocab_size, v.shape)
                 if v.dtype == torch.int64 else
                 gen.standard_normal(v.shape).astype(np.float32)
                 for k, v in args[2].items() if k != "global_tokens"}
        batch["global_tokens"] = np.float32(batch["tokens"].size)
        with fc:
            step(ps, os_, batch, 0)
    elif kind == "prefill":
        step, (_, bspecs) = driver.build_prefill_step(rt, shape)
        batch = {k: gen.integers(0, cfg.vocab_size, v.shape)
                 if v.dtype == torch.int64 else
                 gen.standard_normal(v.shape).astype(np.float32)
                 for k, v in bspecs.items()}
        with fc:
            step(ps, batch)
    else:
        step, args = driver.build_decode_step(rt, shape)
        caches = driver.init_caches(rt, shape)
        tok = np.zeros((shape.global_batch, 1), np.int64)
        with fc:
            step(ps, caches, tok, shape.seq_len - 1)
    return (fc.get_total_flops(), dict(_CountedAttention.calls), len(k1))


# the train step of one config a family, and the serving steps of five
KINDS = [(a, "train") for a in (
    "qwen3-0.6b", "mixtral-8x7b", "deepseek-v2-lite-16b", "zamba2-1.2b",
    "xlstm-1.3b", "whisper-large-v3", "phi-3-vision-4.2b")] + [
    (a, k) for a in ("qwen3-0.6b", "mixtral-8x7b", "deepseek-v2-lite-16b",
                     "zamba2-1.2b", "whisper-large-v3")
    for k in ("prefill", "decode")]


@pytest.mark.parametrize("arch,kind", KINDS)
def test_meta_trace_counts_equal_the_cpu_step_s(arch, kind, monkeypatch):
    flops, k2, k1 = _cpu_counts(arch, kind, monkeypatch)
    monkeypatch.undo()
    cfg, shape = _smoke(arch, kind)
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(2, 2, device="meta"), OPTIONS)
    t = dryrun.trace_step(rt, shape, ranks="all")
    assert t["op_flops"] == flops
    assert t["calls"].get("k2_fwd", 0) == k2["fwd"]
    assert t["calls"].get("k2_bwd", 0) == k2["bwd"]
    assert t["calls"].get("k1", 0) == k1
    if kind == "train":
        assert k1 > 0
        assert {"all-gather", "reduce-scatter"} <= set(t["collectives"])
        assert t["peak_bytes"] > t["base_bytes"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "zamba2-1.2b", "whisper-large-v3"])
def test_one_data_rank_stands_for_every_rank(arch):
    """The default trace runs data rank 0's share: its per-device FLOPs,
    bytes, kernel calls and collectives are the full trace's over the
    ranks, and the simulated device's peak comes within 10%."""
    cfg, shape = _smoke(arch, "train")
    rec = {}
    for ranks in ("one", "all"):
        rt = ChunkedRuntime(model_class(cfg), cfg,
                            make_smoke_mesh(2, 2, device="meta"), OPTIONS)
        rec[ranks] = dryrun.record(rt, shape, ranks=ranks)
    one, full = rec["one"], rec["all"]
    for key in ("flops", "op_flops", "adam_hbm_bytes",
                "collective_link_bytes", "model_flops_per_device",
                "tp_psum_bytes", "k1_calls"):
        assert one[key] == pytest.approx(full[key], rel=1e-12), key
    # the full simulation also sums the ranks' gradients (its stand-in for
    # the reduce-scatter, counted as a collective): bytes one rank has not
    assert 0 < full["hbm_bytes"] - one["hbm_bytes"] \
        <= 0.1 * full["hbm_bytes"]
    assert one["collectives"].keys() == full["collectives"].keys()
    for kind, row in full["collectives"].items():
        assert one["collectives"][kind] == pytest.approx(row), kind
    assert {k: 2 * v for k, v in one["k2_calls"].items()} == \
        full["k2_calls"]
    gap = abs(one["simulated_device_bytes"] - full["simulated_device_bytes"])
    assert gap <= 0.1 * full["simulated_device_bytes"]


@pytest.mark.parametrize("case", [
    dict(shape=(2, 128, 128, 4, 2, 64), causal=True, grad=True),
    dict(shape=(1, 96, 96, 4, 4, 32), causal=True, window=40, grad=True),
    dict(shape=(2, 64, 200, 4, 4, 64), causal=False, grad=True),
    dict(shape=(2, 1, 256, 8, 2, 128), causal=True, q_offset=99,
         kv_len=100),
], ids=["causal", "window", "cross", "decode"])
def test_meta_k2_calls_add_the_shared_work_formula(case):
    b, sq, sk, h, kv, d = case["shape"]
    q = torch.empty((b, sq, h, d), device="meta", dtype=torch.bfloat16,
                    requires_grad=case.get("grad", False))
    k = torch.empty((b, sk, kv, d), device="meta", dtype=torch.bfloat16)
    v = torch.empty((b, sk, kv, d), device="meta", dtype=torch.bfloat16)
    kw = {x: case[x] for x in ("q_offset", "kv_len", "window") if x in case}
    with ops.counting() as work:
        out = ops.flash_attention(q, k, v, causal=case["causal"], **kw)
        fwd = fa.forward_work(b, sq, sk, h, kv, d, d, 2,
                              causal=case["causal"], **kw)
        assert (work.flops, work.bytes) == (fwd["flops"], fwd["bytes"])
        assert out.shape == (b, sq, h, d) and out.device.type == "meta"
        if case.get("grad"):
            (dq,) = torch.autograd.grad(out, q, torch.empty_like(out))
            bwd = fa.backward_work(b, sq, h, kv, d, d, 2,
                                   causal=case["causal"],
                                   window=case.get("window"), sk=sk)
            assert dq.shape == q.shape
            assert work.flops == fwd["flops"] + bwd["flops"]
            assert dict(work.calls) == {"k2_fwd": 1, "k2_bwd": 1}


def test_cpu_and_card_tensors_never_reach_the_meta_branch():
    q = torch.zeros(1, 16, 2, 32)
    with ops.counting() as work:
        ops.flash_attention(q, q, q)
        p = torch.zeros(8)
        ops.chunked_adam(p, p.clone(), p.clone(), p.clone(), out=p.clone(),
                         lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8,
                         weight_decay=0.0, bias_corr1=0.1, bias_corr2=0.05)
    assert not work.calls


# ------------------------------------------------ the gated norm's psums
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_tp_psum_bytes_count_the_gated_norms(arch, monkeypatch):
    """At tp 2 the step's ``tp_psum_bytes`` is ``tp_bytes`` plus the gated
    norms' psums of [B, S, 1] fp32 sums of squares over the ring
    (2 (tp - 1) / tp of the buffer), one a layer and a pass (forward and
    the recompute of full remat), as a spy on the reductions counts
    them."""
    cfg = get_config(arch, smoke=True)
    dp, tp, b, s = 2, 2, 2, 32
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(dp, tp, device="cpu"),
                        RuntimeOptions())
    shape = InputShape("t", s, b, "train")
    seen = []
    real = layers.AxisCtx.psum_model

    def spy(self, xs, *, extra=False):
        xs = list(xs)
        if extra:
            seen.append(xs[0].numel() * 4)
        return real(self, xs, extra=extra)

    monkeypatch.setattr(layers.AxisCtx, "psum_model", spy)
    step, _, _ = driver.build_train_step(rt, shape)
    ps, os_ = driver.init_state(rt, 0)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s))
    _, _, m = step(ps, os_, {"tokens": tok, "labels": np.roll(tok, -1, 1),
                             "global_tokens": np.float32(b * s)}, 0)
    coll = m["collectives"]
    ring = 2 * (tp - 1) / tp
    n_layers = (cfg.num_layers if arch.startswith("zamba")
                else cfg.num_units * cfg.mlstm_per_unit)
    passes = 2  # the forward and the recompute under full remat
    b_loc = b // dp
    want = passes * n_layers * b_loc * s * 4 * ring
    assert coll["tp_psum_bytes"] - coll["tp_bytes"] == pytest.approx(
        want, rel=1e-12)
    # the spy saw every data rank's: a device's share is one rank's
    assert len(seen) == dp * passes * n_layers
    assert sum(seen) * ring / dp == pytest.approx(want, rel=1e-12)


def test_dense_tp_psum_bytes_are_the_cost_model_s():
    cfg = get_config("qwen3-0.6b", smoke=True)
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(1, 2, device="meta"),
                        RuntimeOptions())
    rec = dryrun.record(rt, InputShape("t", 64, 2, "train"))
    assert rec["tp_psum_bytes"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0


def test_cli_writes_a_production_record(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.dryrun`` at the 16 x 16 mesh on the
    meta device: one record a run, in the reference's keys."""
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "qwen3-0.6b", "--shape", "decode_32k",
        "--out", str(tmp_path)])
    dryrun.main()
    import json

    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__1pod.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["chips"] == 256 and rec["collectives"]["all-gather"]["count"]
    for key in ("params_total", "params_active", "per_device_bytes",
                "flops", "hbm_bytes", "collective_link_bytes", "compute_s",
                "memory_s", "collective_s", "dominant",
                "model_flops_per_device", "useful_ratio", "collectives",
                "trace_s", "simulated_device_bytes", "k1_calls",
                "tp_psum_bytes"):
        assert key in rec, key
    skipped = dryrun.dryrun_one("qwen3-0.6b", "long_500k", multi_pod=False,
                                verbose=False)
    assert skipped["status"] == "skipped"
