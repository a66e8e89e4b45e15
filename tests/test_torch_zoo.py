"""The port's model zoo against the JAX package, on the CPU.

The registry of the port holds gpt2-paper-1b and -4b (PatrickStar Table
2), qwen3-0.6b, qwen2.5-3b (GQA 16/2, QKV bias, rope theta 1e6),
deepseek-7b (llama-like, 32 x 128), mixtral-8x7b (8 experts top-2,
GQA 32/8, sliding window 4096), deepseek-v2-lite-16b (MLA, 64 experts
top-6 with 2 shared, a leading dense layer), zamba2-1.2b (38 Mamba2
layers, one shared attention block; its cases are in
``tests/test_torch_zamba.py``), xlstm-1.3b (6 units of 7 mLSTM + 1
sLSTM; its cases are in ``tests/test_torch_xlstm.py``) and
whisper-large-v3 (32 encoder + 32 decoder layers over 1500 stub frames;
its model, trainer and serving cases are in
``tests/test_torch_whisper.py``), phi-3-vision-4.2b (32 layers of 32
heads of 96 over 576 stub patches and the text; its model, trainer and
serving cases are in ``tests/test_torch_vlm.py``) and nemotron-4-340b (96
layers of 96 heads of 192, GQA 12:1, a squared-ReLU un-gated MLP of
73728, vocab 256000, untied).  Here:

* every config, full and smoke, equals the reference's field for field,
  and the full ones carry the published widths (the dense half of
  ``tests/test_archs.py::test_full_config_metadata``, and its audio and
  vlm cases);
* the dense, audio and vlm half of
  ``tests/test_archs.py::test_smoke_train_and_decode`` on a ``(dp=2,
  tp=1)`` mesh: 3 chunked-ZeRO runtime steps from one state on the
  reference test's batch, losses within 1e-5 relative of the JAX
  runtime's (fp32: the same math summed in another order) and falling
  (whisper's stores too, within ADAM's step bound), then one decode step
  whose greedy tokens equal the reference's (the ``tp=2`` mesh waits for
  the port's tensor parallelism);
* the eager trainer and the serving engine on each new smoke config
  (gpt2-paper-4b's has head dim 36): per-step losses within 1e-5 and
  every memory counter identical; greedy tokens and every per-round
  counter identical, under budgets that page chunks;
* ``python -m repro_torch.launch.train --arch <id>`` for each new id;
* mixtral's compiled serving round against the eager engine (the twin of
  ``tests/test_compiled_serving.py``'s MoE case): the eager engine serves
  MoE one sequence a call, the compiled round routes each slot on its
  own; routing the slots pooled instead drops tokens and changes them.

The heavy arch-parametrised cases (the runtime's smoke train and decode,
the eager trainer, the serving engine; mixtral's compiled round) run from
the family files ``tests/test_torch_zoo_<family>.py`` over the shared
bodies of ``tests/_torch_zoo.py``, so no one file sets the wall of a
run that hands whole files to its workers (``--dist loadfile``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jax_mesh  # noqa: E402
from repro.models.layers import AxisCtx  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro.runtime.step import RuntimeOptions as JaxOptions  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, model_class  # noqa: E402
from repro_torch.configs.base import BaseConfig  # noqa: E402
from repro_torch.convert import params_from_jax, stores_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

NEW = ["gpt2-paper-4b", "qwen2.5-3b", "deepseek-7b", "mixtral-8x7b",
       "deepseek-v2-lite-16b", "nemotron-4-340b"]
FP32 = dict(param_dtype="float32", compute_dtype="float32")
LOSS_TOL = 1e-5

# the published widths (test_archs.py's table, and PatrickStar Table 2)
FULL = {
    "gpt2-paper-1b": dict(num_layers=20, d_model=2048, n_heads=16,
                          head_dim=128, d_ff=8192, vocab_size=50304),
    "gpt2-paper-4b": dict(num_layers=64, d_model=2304, n_heads=16,
                          n_kv_heads=16, head_dim=144, d_ff=9216,
                          vocab_size=50304, tie_embeddings=True),
    "qwen3-0.6b": dict(num_layers=28, d_model=1024, n_heads=16,
                       n_kv_heads=8, d_ff=3072, vocab_size=151936),
    "qwen2.5-3b": dict(num_layers=36, d_model=2048, n_heads=16,
                       n_kv_heads=2, d_ff=11008, vocab_size=151936,
                       qkv_bias=True, rope_theta=1_000_000.0),
    "deepseek-7b": dict(num_layers=30, d_model=4096, n_heads=32,
                        n_kv_heads=32, d_ff=11008, vocab_size=102400),
    "mixtral-8x7b": dict(num_layers=32, d_model=4096, n_heads=32,
                         n_kv_heads=8, head_dim=128, d_ff=14336,
                         d_ff_expert=14336, vocab_size=32000, n_experts=8,
                         top_k=2, sliding_window=4096, tie_embeddings=True),
    "deepseek-v2-lite-16b": dict(num_layers=27, d_model=2048, n_heads=16,
                                 head_dim=128, d_ff=10944, d_ff_expert=1408,
                                 vocab_size=102400, n_experts=64, top_k=6,
                                 n_shared_experts=2, first_dense_layers=1,
                                 kv_lora_rank=512, qk_nope_dim=128,
                                 qk_rope_dim=64, v_head_dim=128,
                                 tie_embeddings=True),
    "zamba2-1.2b": dict(num_layers=38, d_model=2048, n_heads=32,
                        n_kv_heads=32, head_dim=128, d_ff=8192,
                        vocab_size=32000, ssm_state=64, shared_interval=6,
                        tail_layers=2, d_inner=4096, mamba_heads=64),
    "xlstm-1.3b": dict(num_layers=48, d_model=2048, n_heads=4,
                       vocab_size=50304, mlstm_per_unit=7, slstm_per_unit=1,
                       num_units=6, d_inner=4096, chunk_len=64),
    "whisper-large-v3": dict(num_layers=32, num_encoder_layers=32,
                             d_model=1280, n_heads=20, n_kv_heads=20,
                             head_dim=64, d_ff=5120, vocab_size=51866,
                             encoder_frames=1500, frontend_dim=128,
                             gated_mlp=False, norm="ln"),
    "phi-3-vision-4.2b": dict(num_layers=32, d_model=3072, n_heads=32,
                              n_kv_heads=32, head_dim=96, d_ff=8192,
                              vocab_size=32064, num_patches=576,
                              vision_dim=1024, gated_mlp=True,
                              tie_embeddings=True),
    "nemotron-4-340b": dict(num_layers=96, d_model=18432, n_heads=96,
                            n_kv_heads=8, head_dim=192, d_ff=73728,
                            vocab_size=256000, activation="relu2",
                            gated_mlp=False, tie_embeddings=False),
}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_reference_field_for_field(arch, smoke):
    cfg, ref = get_config(arch, smoke=smoke), jax_config(arch, smoke=smoke)
    assert type(cfg).__name__ == type(ref).__name__
    fields = dataclasses.fields(type(cfg))
    assert [f.name for f in fields] == [f.name for f in
                                        dataclasses.fields(type(ref))]
    for f in fields:
        assert getattr(cfg, f.name) == getattr(ref, f.name), (arch, f.name)
    if hasattr(cfg, "use_mla"):
        assert cfg.use_mla == ref.use_mla
    if not smoke:
        for key, want in FULL[arch].items():
            assert getattr(cfg, key) == want, (arch, key)
        # zamba's shared attention block runs at 2 x d_model
        width = 2 * cfg.d_model if cfg.arch_type == "hybrid" \
            else cfg.d_model
        assert cfg.n_heads * cfg.head_dim == width or arch == "qwen3-0.6b"
    if cfg.arch_type == "hybrid":
        for prop in ("num_units", "tail_layers", "d_inner", "mamba_heads"):
            assert getattr(cfg, prop) == getattr(ref, prop), (arch, prop)
    if cfg.arch_type in ("ssm", "audio"):
        props = ("subquadratic_decode",) if cfg.arch_type == "audio" \
            else ("num_units", "d_inner", "subquadratic_decode")
        for prop in props:
            assert getattr(cfg, prop) == getattr(ref, prop), (arch, prop)


def test_the_registry_holds_the_dense_zoo():
    """The dense zoo, mixtral, deepseek-v2-lite, zamba2, xlstm, whisper
    and phi-3-vision: every id maps to its model class, an MLA config
    (deepseek-v2-lite's attention on mixtral's widths) to ``MoELM``, as in
    the reference; an arch type no config defines raises."""
    assert set(ARCH_IDS) == set(FULL)
    moe = ("mixtral-8x7b", "deepseek-v2-lite-16b")
    named = {"zamba2-1.2b": "ZambaLM", "xlstm-1.3b": "XLSTMLM",
             "whisper-large-v3": "WhisperBackbone",
             "phi-3-vision-4.2b": "VLMBackbone"}
    for arch in ARCH_IDS:
        want = ("MoELM" if arch in moe else named.get(arch,
                                                      "TransformerLM"))
        assert model_class(get_config(arch)).__name__ == want
        assert want == jax_model_class(jax_config(arch)).__name__
    mla = jax_config("deepseek-v2-lite-16b")
    port_mla = get_config("mixtral-8x7b").replace(
        **{f: getattr(mla, f) for f in ("kv_lora_rank", "qk_nope_dim",
                                        "qk_rope_dim", "v_head_dim")})
    assert port_mla.use_mla
    assert model_class(port_mla).__name__ == "MoELM" == \
        jax_model_class(mla).__name__
    with pytest.raises(KeyError, match="unknown arch_type"):
        model_class(get_config("mixtral-8x7b").replace(arch_type="nobody"))


def test_convert_carries_the_untied_head_and_the_plain_mlp():
    """nemotron's leaves through ``params_from_jax`` and
    ``stores_from_jax``: the untied head (``unembed``) beside the
    embedding, the squared-ReLU MLP's ``w_up`` and ``w_down`` and no
    ``w_gate``, every leaf shaped as the port's own init's, and the
    reference runtime's stores shaped and typed as the port's."""
    from repro_torch.models.api import flatten_with_paths

    jcfg = jax_config("nemotron-4-340b", smoke=True)
    cfg = get_config("nemotron-4-340b", smoke=True)
    got = params_from_jax(numpy_params(jax_model_class(jcfg)(jcfg,
                                                             AxisCtx()), 0))
    assert set(got["stem"]) == {"embed", "unembed", "final_norm"}
    assert set(got["groups"]["layers"]["mlp"]) == {"w_up", "w_down"}
    with torch.device("meta"):
        mine = model_class(cfg)(cfg, AxisCtx()).init_params(
            torch.Generator())
    assert {p: tuple(t.shape) for p, t in flatten_with_paths(got)} == \
        {p: tuple(t.shape) for p, t in flatten_with_paths(mine)}
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(1, 1),
                     JaxOptions())
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(1, 1, device="cpu"), RuntimeOptions())
    ps, os_ = stores_from_jax(*jax.device_get(jax_driver.init_state(
        jrt, jax.random.key(0))))
    assert {k: (tuple(v.shape), v.dtype) for k, v in ps.items()} == \
        {k: (tuple(v.shape), v.dtype)
         for k, v in driver.param_stores(rt, got).items()}
    assert set(os_) == set(ps)


def test_head_casts_a_large_low_precision_table_by_blocks(monkeypatch):
    """``lm_logits_local`` casts a bf16 table past ``4 * HEAD_CAST_BLOCK``
    elements to fp32 a block of vocab rows at a time (nemotron's 256000 x
    18432 head would otherwise take an 18.9 GB fp32 copy): the same fp32
    logits as the whole cast, and the reference's, at a block of 3 rows
    (so the last block is ragged); an fp32 table is never cut."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    rng = np.random.default_rng(3)
    table = rng.standard_normal((100, 64)).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(ref_layers.lm_logits_local(
        {"table": jnp.asarray(table, jnp.bfloat16)},
        jnp.asarray(x, jnp.bfloat16), AxisCtx()))
    tt = torch.from_numpy(table).to(torch.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    whole = layers.lm_logits_local({"table": tt}, tx, None)
    monkeypatch.setattr(layers, "HEAD_CAST_BLOCK", 3 * 64)
    blocked = layers.lm_logits_local({"table": tt}, tx, None)
    assert blocked.dtype == torch.float32 and blocked.shape == (2, 5, 100)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(blocked.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", NEW + ["whisper-large-v3",
                                        "phi-3-vision-4.2b"])
def test_train_cli_takes_the_new_arch_ids(arch, capsys):
    """``python -m repro_torch.launch.train --arch <id>`` on the CPU, one
    step of the smoke config (16 text tokens a row, after the patches for
    the vlm family); an id outside the registry raises."""
    from repro_torch.launch import train

    seq = 16 + getattr(get_config(arch, smoke=True), "num_patches", 0)
    train.main(["--device", "cpu", "--smoke", "--arch", arch, "--steps",
                "1", "--batch", "2", "--seq", str(seq)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={get_config(arch, smoke=True).name} ")
    assert any(line.startswith("step ") for line in out)
    with pytest.raises(KeyError, match="unknown arch"):
        train.main(["--device", "cpu", "--arch", "nemotron-4-15b"])
