"""The port's analytical cost model (``repro_torch.analysis.costmodel``)
against the reference's (``repro.analysis.costmodel``), under a
``Hardware`` built from the reference's own roofline constants: the
ledger terms and the per-operator durations the transfer timeline
installs are equal, for every family of the registry: dense, vlm, moe
(GQA and MLA attention), ssm, hybrid and audio (rel 1e-12; the sums run
in the reference's order, so in practice to the bit), with
``analyze_pair``'s options; the eager trainer's transfer timeline on
mixtral-smoke and on deepseek-v2-lite-smoke (MLA) equals the
reference's.  Then the reference's own scaling properties that apply to
the dense family, on the port, and the port's H100 record: no TPU
constant in it, links from measurements."""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.analysis import costmodel as ref_cm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from _torch_parity import reference_hardware  # noqa: E402
from repro_torch.analysis import costmodel as cm  # noqa: E402
from repro_torch.analysis.roofline import H100_SXM  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.models.layers import AxisCtx  # noqa: E402

# the dense family: nemotron-4-340b's un-gated squared-ReLU MLP and untied
# head beside the gated, tied ones
ARCHS = ["gpt2-paper-1b", "qwen3-0.6b", "nemotron-4-340b"]
REL = 1e-12


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _shape(kind, s, b):
    return InputShape("t", s, b, kind)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_ledger_and_durations_match_reference(arch, smoke):
    from repro.configs.base import InputShape as RefShape

    hw = reference_hardware()
    jcfg, cfg = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    for kind, s, b, dp, tp, pods, remat in [
            ("train", 1024, 8, 1, 1, 1, "full"),
            ("train", 64, 4, 2, 1, 1, "dots"),
            ("train", 512, 16, 4, 2, 2, "full"),
            ("prefill", 500, 1, 1, 1, 1, "full"),
            ("decode", 1024, 4, 1, 1, 1, "full")]:
        want = ref_cm.analyze_pair(jcfg, RefShape("t", s, b, kind), dp=dp,
                                   tp=tp, pods=pods, remat=remat)
        got = cm.analyze_pair(cfg, _shape(kind, s, b), dp=dp, tp=tp,
                              pods=pods, remat=remat)
        for f in ("flops", "hbm_bytes", "zero_bytes", "tp_bytes",
                  "pod_bytes"):
            assert _close(getattr(got, f), getattr(want, f)), (kind, f)
        assert got.seconds(hw) == want.seconds()
    for b, s, layers, chunk in [(4, 64, 4, 262_144), (8, 1024, 20, 142_606_336)]:
        want = ref_cm.train_operator_costs(
            jcfg, global_batch=b, seq_len=s, num_layer_ops=layers,
            chunk_bytes=chunk)
        got = cm.train_operator_costs(
            cfg, hw=hw, global_batch=b, seq_len=s, num_layer_ops=layers,
            chunk_bytes=chunk)
        assert (got.fwd_layer_s, got.bwd_layer_s, got.adam_chunk_s) == \
            (want.fwd_layer_s, want.bwd_layer_s, want.adam_chunk_s)
        for op, phase in [("layers.0", "FWD"), ("layers.0", "BWD"),
                          ("adam.3", "ADAM"), ("layers.0.end", "FWD"),
                          ("embed", "STEM")]:
            assert got.of_moment(op, phase) == want.of_moment(op, phase)
    for prompt, horizon in [(8, 40), (500, 1024), (1, 1)]:
        want = ref_cm.serve_operator_costs(
            jcfg, prompt_tokens=prompt, horizon=horizon,
            num_layers=jcfg.num_layers)
        got = cm.serve_operator_costs(
            cfg, hw=hw, prompt_tokens=prompt, horizon=horizon,
            num_layers=cfg.num_layers)
        assert (got.prefill_layer_s, got.decode_layer_s) == \
            (want.prefill_layer_s, want.decode_layer_s)
    for tp in (1, 2, 16):
        assert cm._param_bytes_local(cfg, tp) == \
            ref_cm._param_bytes_local(jcfg, tp)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b"])
def test_ssm_and_hybrid_ledgers_match_reference(arch, shape):
    """xLSTM's mLSTM and sLSTM terms and zamba2's Mamba2 layers and
    shared block: the ledger, its seconds and the bf16 parameter bytes
    equal the reference's at each of its input shapes, on one device and
    on a (pods 2, dp 16, tp 16) mesh."""
    from repro.configs.base import INPUT_SHAPES

    hw = reference_hardware()
    jcfg, cfg = jax_config(arch), get_config(arch)
    ref_shape = INPUT_SHAPES[shape]
    mine = _shape(ref_shape.kind, ref_shape.seq_len, ref_shape.global_batch)
    for dp, tp, pods in [(1, 1, 1), (16, 16, 2)]:
        want = ref_cm.analyze_pair(jcfg, ref_shape, dp=dp, tp=tp, pods=pods)
        got = cm.analyze_pair(cfg, mine, dp=dp, tp=tp, pods=pods)
        for f in ("flops", "hbm_bytes", "zero_bytes", "tp_bytes",
                  "pod_bytes"):
            assert _close(getattr(got, f), getattr(want, f)), (dp, f)
        assert got.seconds(hw) == want.seconds()
        assert cm._param_bytes_local(cfg, tp) == \
            ref_cm._param_bytes_local(jcfg, tp)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_audio_ledger_matches_reference(shape):
    """whisper-large-v3's encoder over its frames (none at decode) and its
    decoder with the cross-attention: the ledger, its seconds, the
    per-operator durations the eager trainer installs and the bf16
    parameter bytes equal the reference's, on one device and on a
    (pods 2, dp 16, tp 16) mesh."""
    from repro.configs.base import INPUT_SHAPES

    hw = reference_hardware()
    arch = "whisper-large-v3"
    jcfg, cfg = jax_config(arch), get_config(arch)
    ref_shape = INPUT_SHAPES[shape]
    mine = _shape(ref_shape.kind, ref_shape.seq_len, ref_shape.global_batch)
    for dp, tp, pods in [(1, 1, 1), (16, 16, 2)]:
        want = ref_cm.analyze_pair(jcfg, ref_shape, dp=dp, tp=tp, pods=pods)
        got = cm.analyze_pair(cfg, mine, dp=dp, tp=tp, pods=pods)
        for f in ("flops", "hbm_bytes", "zero_bytes", "tp_bytes",
                  "pod_bytes"):
            assert _close(getattr(got, f), getattr(want, f)), (dp, f)
        assert got.seconds(hw) == want.seconds()
        assert cm._param_bytes_local(cfg, tp) == \
            ref_cm._param_bytes_local(jcfg, tp)
    want = ref_cm.train_operator_costs(jcfg, global_batch=4, seq_len=1500,
                                       num_layer_ops=64, chunk_bytes=1 << 26)
    got = cm.train_operator_costs(cfg, hw=hw, global_batch=4, seq_len=1500,
                                  num_layer_ops=64, chunk_bytes=1 << 26)
    assert (got.fwd_layer_s, got.bwd_layer_s, got.adam_chunk_s) == \
        (want.fwd_layer_s, want.bwd_layer_s, want.adam_chunk_s)


def _terms(arch, kind, s, b, **kw):
    return cm.analyze_pair(get_config(arch), _shape(kind, s, b),
                           **dict(dict(dp=16, tp=16), **kw))


def test_flops_scale_with_tokens():
    a = _terms("qwen3-0.6b", "train", 4096, 256)
    half = _terms("qwen3-0.6b", "train", 2048, 256)
    assert 1.7 < a.flops / half.flops < 2.4  # ~linear + attention


def test_train_costs_more_than_prefill():
    """Per token, train = fwd + bwd + re-fwd ~ 4x a prefill's fwd (at one
    sequence length: at 32k a small model's prefill is all attention)."""
    t = _terms("qwen3-0.6b", "train", 4096, 256)
    p = _terms("qwen3-0.6b", "prefill", 4096, 256)
    assert t.flops > 2.5 * p.flops


def test_decode_is_tiny():
    d = _terms("qwen3-0.6b", "decode", 32768, 128)
    t = _terms("qwen3-0.6b", "train", 4096, 256)
    assert d.flops < t.flops / 100


def test_dots_remat_cuts_compute():
    base = _terms("gpt2-paper-1b", "train", 4096, 256)
    dots = _terms("gpt2-paper-1b", "train", 4096, 256, remat="dots")
    assert abs(dots.flops / base.flops - 0.75) < 0.02


def test_pod_axis_adds_grad_psum():
    one = _terms("qwen3-0.6b", "train", 4096, 256)
    two = _terms("qwen3-0.6b", "train", 4096, 256, pods=2)
    assert two.pod_bytes > 0 and one.pod_bytes == 0


@pytest.mark.parametrize("arch", ARCHS + ["whisper-large-v3",
                                          "phi-3-vision-4.2b"])
def test_param_bytes_match_the_model(arch):
    """At tp=1 the cost model's bf16 parameter bytes are the model's own
    parameter count, norms aside (within 1%)."""
    cfg = get_config(arch)
    specs = model_class(cfg)(cfg, AxisCtx()).param_specs()
    from repro_torch.models.api import flatten_with_paths

    real = sum(int(np.prod(s.shape)) for _, s in flatten_with_paths(specs)) * 2
    est = cm._param_bytes_local(cfg, 1)
    assert abs(est - real) / real < 0.01, (est, real)


# (arch, smoke, moe_impl override): phi-3-vision, mixtral (GQA, window)
# and deepseek-v2-lite (MLA, shared experts, a leading dense layer), full
# and smoke, and the experts sharded over the model axis ("ep")
MOE_VLM = [("phi-3-vision-4.2b", False, None),
           ("phi-3-vision-4.2b", True, None),
           ("mixtral-8x7b", True, None), ("mixtral-8x7b", False, None),
           ("mixtral-8x7b", False, "ep"),
           ("deepseek-v2-lite-16b", True, None),
           ("deepseek-v2-lite-16b", False, None),
           ("deepseek-v2-lite-16b", False, "ep")]


@pytest.mark.parametrize("arch,smoke,impl", MOE_VLM,
                         ids=[f"{a}-{'smoke' if s else 'full'}"
                              f"{'-' + i if i else ''}"
                              for a, s, i in MOE_VLM])
def test_moe_mla_and_vlm_ledgers_match_reference(arch, smoke, impl):
    """The MoE layer (router, capacity, experts, shared experts, the
    expert-output psum), MLA (absorbed at decode) and the vlm decoder
    with its projector's bytes: the ledger and its seconds at the
    reference's input shapes, on one device and on (pods 2, dp 16, tp 16),
    with ``analyze_pair``'s ``gather_per_layer``, ``ep_combine_first`` and
    ``zero_gathers_train``; the per-operator durations of training and
    serving; the bf16 parameter bytes at tp 1, 2 and 16."""
    from repro.configs.base import INPUT_SHAPES

    hw = reference_hardware()
    jcfg, cfg = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    if impl:
        jcfg, cfg = jcfg.replace(moe_impl=impl), cfg.replace(moe_impl=impl)
    options = [{}, dict(gather_per_layer=False, ep_combine_first=True,
                        zero_gathers_train=1),
               dict(ep_combine_first=False, zero_gathers_train=3)]
    for ref_shape in INPUT_SHAPES.values():
        mine = _shape(ref_shape.kind, ref_shape.seq_len,
                      ref_shape.global_batch)
        for dp, tp, pods in [(1, 1, 1), (16, 16, 2)]:
            for opt in options:
                want = ref_cm.analyze_pair(jcfg, ref_shape, dp=dp, tp=tp,
                                           pods=pods, **opt)
                got = cm.analyze_pair(cfg, mine, dp=dp, tp=tp, pods=pods,
                                      **opt)
                for f in ("flops", "hbm_bytes", "zero_bytes", "tp_bytes",
                          "pod_bytes"):
                    assert _close(getattr(got, f), getattr(want, f)), \
                        (ref_shape.name, dp, opt, f)
                assert got.seconds(hw) == want.seconds()
    want = ref_cm.train_operator_costs(jcfg, global_batch=4, seq_len=2048,
                                       num_layer_ops=cfg.num_layers,
                                       chunk_bytes=1 << 26, dp=2)
    got = cm.train_operator_costs(cfg, hw=hw, global_batch=4, seq_len=2048,
                                  num_layer_ops=cfg.num_layers,
                                  chunk_bytes=1 << 26, dp=2)
    assert (got.fwd_layer_s, got.bwd_layer_s, got.adam_chunk_s) == \
        (want.fwd_layer_s, want.bwd_layer_s, want.adam_chunk_s)
    for prompt, horizon in [(8, 40), (1024, 1040)]:
        want = ref_cm.serve_operator_costs(
            jcfg, prompt_tokens=prompt, horizon=horizon,
            num_layers=jcfg.num_layers)
        got = cm.serve_operator_costs(
            cfg, hw=hw, prompt_tokens=prompt, horizon=horizon,
            num_layers=cfg.num_layers)
        assert (got.prefill_layer_s, got.decode_layer_s) == \
            (want.prefill_layer_s, want.decode_layer_s)
    for tp in (1, 2, 16):
        assert cm._param_bytes_local(cfg, tp) == \
            ref_cm._param_bytes_local(jcfg, tp)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_moe_eager_trainer_timeline_matches_reference(arch):
    """The eager trainer with ``timeline=`` on mixtral-smoke and on
    deepseek-v2-lite-smoke (MLA; the cost model raised for both before):
    2 steps under a paging budget and finite lanes, losses within 1e-5,
    every ``StepTimeline`` field identical to the reference trainer's."""
    import dataclasses

    from repro.configs import model_class as jax_model_class
    from repro.core.engine import PatrickStarEngine as RefEngine
    from repro.core.timeline import TransferTimeline as RefTimeline
    from repro.models.layers import AxisCtx as JaxCtx
    from _torch_parity import numpy_params, timeline_fields
    from repro_torch.convert import params_from_jax
    from repro_torch.core.engine import PatrickStarEngine
    from repro_torch.core.timeline import TransferTimeline
    from repro_torch.data.pipeline import make_batch_fn

    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = jax_config(arch, smoke=True).replace(**fp32)
    cfg = get_config(arch, smoke=True).replace(**fp32)
    base = jax_model_class(jcfg)

    class Jitted(base):  # the reference's layers under jit, not op by op
        def groups(self):
            if not hasattr(self, "_jitted_groups"):
                self._jitted_groups = [dataclasses.replace(
                    g, apply=jax.jit(g.apply, static_argnums=3))
                    for g in super().groups()]
            return self._jitted_groups

    params = numpy_params(base(jcfg, JaxCtx()), 0)
    nxt = make_batch_fn(cfg, 2, 32)
    batches = [{k: v for k, v in nxt().items() if k != "mask"}
               for _ in range(2)]
    bw = dict(h2d_bandwidth=1e8, d2h_bandwidth=1e8)
    kw = dict(device_memory_bytes=4_000_000, policy="opt", lr=1e-3)
    ref = RefEngine(Jitted, jcfg, init_params=params,
                    timeline=RefTimeline(**bw), **kw)
    port = PatrickStarEngine(
        model_class(cfg), cfg, device="cpu",
        init_params=params_from_jax(params),
        timeline=TransferTimeline(hardware=reference_hardware(), **bw), **kw)
    for i, batch in enumerate(batches):
        a, b = ref.step(batch), port.step(batch)
        assert abs(a.loss - b.loss) <= 1e-5 * abs(a.loss), (i, a.loss, b.loss)
        assert timeline_fields(b.timeline) == timeline_fields(a.timeline), i
    assert b.timeline.compute_s > 0


def test_other_families_raise():
    """An arch type outside the registry's families raises (the
    reference prices only its stem)."""
    cfg = get_config("qwen3-0.6b").replace(arch_type="nobody")
    with pytest.raises(KeyError, match="unknown arch_type"):
        cm.analyze_pair(cfg, _shape("train", 64, 4), dp=1, tp=1)
    with pytest.raises(KeyError, match="unknown arch_type"):
        cm._param_bytes_local(cfg, 1)


def test_h100_record_holds_no_tpu_constant():
    """The H100 record is the card's: compute and HBM from NVIDIA's
    datasheet, links measured (finite h2d/d2h, so ``calibrated()`` never
    falls back to an infinite lane), the CPU-memory slow tier infinite —
    and no TPU-class number appears anywhere in the port."""
    from repro.analysis import roofline

    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw) == (989e12, 3.35e12)
    for bw in (H100_SXM.h2d_bw, H100_SXM.d2h_bw, H100_SXM.collective_bw):
        assert bw is not None and math.isfinite(bw) and bw > 0
    assert H100_SXM.slow_bw is None
    tpu = {roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW,
           roofline.HOST_LINK_BW, roofline.NVME_BW}
    assert not tpu & {H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.h2d_bw,
                      H100_SXM.d2h_bw, H100_SXM.collective_bw}
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    literal = re.compile(r"(?<![\w.])(197e12|819e9|50e9|32e9|6e9)(?![\w.])")
    for path in sorted(root.rglob("*.py")):
        assert not literal.findall(path.read_text()), path
