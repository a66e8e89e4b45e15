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
from repro.models.layers import AxisCtx  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro.runtime.step import RuntimeOptions as JaxOptions  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, model_class  # noqa: E402
from repro_torch.configs.base import BaseConfig, InputShape  # noqa: E402
from repro_torch.convert import params_from_jax, stores_from_jax  # noqa: E402
from repro_torch.core.engine import PatrickStarEngine  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.serve import CompiledServingEngine  # noqa: E402
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


def _reference_batch(cfg, b, s):
    """``test_archs.py``'s batch (``jax.random.key(1)``), as numpy: for the
    audio family ``min(encoder_frames, s)`` frames and random labels, for
    the vlm family ``num_patches`` patches ahead of ``s - num_patches``
    tokens and random labels."""
    ks = jax.random.split(jax.random.key(1), 3)
    if cfg.arch_type == "vlm":
        st = s - cfg.num_patches
        return {"patch_embeds": np.asarray(jax.random.normal(
                    ks[0], (b, cfg.num_patches, cfg.vision_dim))),
                "tokens": np.asarray(jax.random.randint(
                    ks[1], (b, st), 0, cfg.vocab_size)),
                "labels": np.asarray(jax.random.randint(
                    ks[2], (b, st), 0, cfg.vocab_size)),
                "global_tokens": np.float32(b * st)}
    if cfg.arch_type == "audio":
        f = min(cfg.encoder_frames, s)
        return {"frames": np.asarray(jax.random.normal(
                    ks[0], (b, f, cfg.frontend_dim))),
                "tokens": np.asarray(jax.random.randint(
                    ks[1], (b, s), 0, cfg.vocab_size)),
                "labels": np.asarray(jax.random.randint(
                    ks[2], (b, s), 0, cfg.vocab_size)),
                "global_tokens": np.float32(b * s)}
    tok = np.asarray(jax.random.randint(ks[1], (b, s), 0, cfg.vocab_size))
    return {"tokens": tok, "labels": np.roll(tok, -1, 1),
            "global_tokens": np.float32(b * s)}


@pytest.mark.parametrize("arch", NEW + ["whisper-large-v3",
                                        "phi-3-vision-4.2b"])
def test_smoke_train_and_decode_matches_reference(arch):
    jcfg = jax_config(arch, smoke=True).replace(**FP32)
    cfg = get_config(arch, smoke=True).replace(**FP32)
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(2, 1),
                     JaxOptions())
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(2, 1, device="cpu"), RuntimeOptions())
    jps, jos = jax_driver.init_state(jrt, jax.random.key(0))
    ps, os_ = driver.place_state(rt, *stores_from_jax(jax.device_get(jps),
                                                      jax.device_get(jos)))
    jstep, _, _ = jax_driver.build_train_step(
        jrt, JaxShape("smoke", 64, 4, "train"))
    step, _, _ = driver.build_train_step(rt, InputShape("smoke", 64, 4,
                                                        "train"))
    batch = _reference_batch(cfg, 4, 64)
    losses = []
    for i in range(3):
        jps, jos, jm = jstep(jps, jos, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                             jnp.int32(i))
        ps, os_, m = step(ps, os_, batch, i)
        ref, got = float(jm["loss"]), float(m["loss"])
        assert np.isfinite(got) and abs(got - ref) <= LOSS_TOL * abs(ref), \
            (i, ref, got)
        # the router's load-balance loss (0 for the dense family)
        np.testing.assert_allclose(float(m["aux_loss"]),
                                   float(jm["aux_loss"]), rtol=LOSS_TOL,
                                   atol=1e-7)
        losses.append(got)
    assert losses[-1] < losses[0], losses  # memorizes the repeated batch
    for name, t in ps.items():
        assert bool(torch.isfinite(t.float()).all()), name
    if cfg.arch_type == "audio":
        # the encoder-decoder's stores too (its training crosses a group
        # boundary the dense family does not have)
        _assert_stores_match((jps, jos), (ps, os_), steps=3, lr=rt.opt.lr)

    dshape = InputShape("serve", 64, 4, "decode")
    dec, _ = driver.build_decode_step(rt, dshape)
    tok = np.zeros((4, 1), np.int32)
    nxt, _ = dec(ps, driver.init_caches(rt, dshape), tok, 5)
    jshape = JaxShape("serve", 64, 4, "decode")
    jdec, _ = jax_driver.build_decode_step(jrt, jshape)
    jnxt, _ = jdec(jps, jax_driver.init_caches(jrt, jshape),
                   jnp.asarray(tok), jnp.int32(5))
    assert nxt.shape == (4,)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def _parts(pstores, osstores):
    out = {f"param/{k}": v for k, v in pstores.items()}
    for name, streams in osstores.items():
        for k, parts in streams.items():
            for part, t in parts.items():
                out[f"{name}/{k}/{part}"] = t
    return out


def _assert_stores_match(ref, got, *, steps, lr):
    """Every store part (params, p32, m and v) equal to the reference's
    within 1e-5 but for at most 1e-4 of its elements, those within ADAM's
    step bound (its first step is ~sign(g), so a near-zero gradient may
    flip; the rule of ``tests/test_torch_runtime.py``)."""
    want = _parts(*stores_from_jax(*jax.device_get(ref)))
    mine = _parts(*got)
    assert want.keys() == mine.keys()
    for key, w in want.items():
        assert mine[key].shape == w.shape, key
        if not w.numel():
            continue
        err = (w.double() - mine[key].double()).abs()
        assert int((err > LOSS_TOL).sum()) <= 1e-4 * w.numel(), key
        assert float(err.max()) <= 2 * steps * lr, (key, float(err.max()))


TRAIN_COUNTERS = ("h2d_bytes", "d2h_bytes", "adam_h2d_bytes",
                  "adam_d2h_bytes", "hidden_h2d_bytes", "critical_h2d_bytes",
                  "prefetch_hits", "demand_misses", "peak_device_bytes")


def _train(eng, batches):
    out = []
    for batch in batches:
        m = eng.step(batch)
        out.append((m.loss, {f: getattr(m, f) for f in TRAIN_COUNTERS}))
    return out


@pytest.mark.parametrize("arch", NEW)
def test_eager_trainer_matches_reference(arch):
    """The quickstart's engine options (4 MB, OPT, prefetch, the act
    stream, placement) on the smoke config, 4 steps of batch 4 x 64."""
    jcfg = jax_config(arch, smoke=True).replace(**FP32)
    cfg = get_config(arch, smoke=True).replace(**FP32)
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    nxt = make_batch_fn(cfg, 4, 64)
    batches = [{k: v for k, v in nxt().items() if k != "mask"}
               for _ in range(4)]
    # the MoE models at lr 1e-3: ADAM's first steps move every weight by
    # ~lr, and top-k routing is discontinuous, so at 1e-2 a 1e-7 relative
    # change of the port's own initial weights moves mixtral's step-2 loss
    # by ~8e-5 and deepseek-v2-lite's step-1 loss by 1.2e-5 (step 0 and
    # the gradients agree to ~1e-6 across the packages)
    lr = 1e-3 if arch in ("mixtral-8x7b", "deepseek-v2-lite-16b") else 1e-2
    kw = dict(device_memory_bytes=4_000_000, policy="opt", lr=lr)
    ref = RefEngine(jax_model_class(jcfg), jcfg, init_params=params, **kw)
    port = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                             init_params=params_from_jax(params), **kw)
    want, got = _train(ref, batches), _train(port, batches)
    for i, ((lw, cw), (lg, cg)) in enumerate(zip(want, got)):
        assert np.isfinite(lg) and abs(lg - lw) <= LOSS_TOL, (i, lg, lw)
        assert cg == cw, i
    assert sum(c["h2d_bytes"] for _, c in got) > 0  # the budget pages
    port.pool.check_invariants()


SERVE_COUNTERS = ("admitted", "completed", "active", "queued",
                  "prefill_tokens", "decode_tokens", "h2d_bytes", "d2h_bytes",
                  "hidden_h2d_bytes", "critical_h2d_bytes", "prefetch_hits",
                  "demand_misses", "peak_device_bytes")


def _rounds(engine):
    out = []
    while (m := engine.step_round()) is not None:
        out.append({f: getattr(m, f) for f in SERVE_COUNTERS})
    return out


@pytest.mark.parametrize("arch", NEW)
def test_serving_engine_matches_reference(arch):
    """Three prompts, 4 new tokens each, under a device budget below the
    param stream: greedy tokens and every per-round counter identical."""
    jcfg = jax_config(arch, smoke=True).replace(**FP32)
    cfg = get_config(arch, smoke=True).replace(**FP32)
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    # mixtral's layer (4 experts) and nemotron-smoke's (d_ff 768) alone are
    # 1.6 MB: their floor is higher
    budget = 2_800_000 if arch in ("mixtral-8x7b", "nemotron-4-340b") \
        else 1_600_000
    kw = dict(device_memory_bytes=budget, host_memory_bytes=16_000_000,
              max_seq_len=16)
    ref = RefServing(jax_model_class(jcfg), jcfg, init_params=params, **kw)
    port = ServingEngine(model_class(cfg), cfg, device="cpu",
                         init_params=params_from_jax(params), **kw)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (9, 9, 5)]
    for p in prompts:
        assert ref.submit(p, 4) == port.submit(p, 4)
    want, got = _rounds(ref), _rounds(port)
    for rid in range(len(prompts)):
        assert port.result(rid) == ref.result(rid)
    assert got == want
    assert sum(r["h2d_bytes"] for r in got) > 0  # the budget pages
    port.check_invariants()


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


def _burst(cfg, n=6, plen=8, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (n, plen))


_NEW_TOKENS = [8, 3, 8, 5, 8, 8]


def _serve_all(cls, cfg, params, prompts, **kw):
    eng = cls(model_class(cfg), cfg, device="cpu", init_params=params,
              device_memory_bytes=2_800_000, host_memory_bytes=24_000_000,
              max_seq_len=24, **kw)
    rids = [eng.submit(p, n) for p, n in zip(prompts, _NEW_TOKENS)]
    for m in eng.run():
        assert m.peak_device_bytes <= eng.device_capacity
    eng.check_invariants()
    return eng, [eng.result(r) for r in rids]


def _moe_case(capacity_factor=None):
    jcfg = jax_config("mixtral-8x7b", smoke=True).replace(**FP32)
    cfg = get_config("mixtral-8x7b", smoke=True).replace(**FP32)
    if capacity_factor is not None:
        jcfg = jcfg.replace(capacity_factor=capacity_factor)
        cfg = cfg.replace(capacity_factor=capacity_factor)
    params = numpy_params(jax_model_class(jcfg)(jcfg, AxisCtx()), 0)
    return jcfg, cfg, params


def test_compiled_round_matches_eager_moe():
    """The twin of ``test_compiled_serving.py``'s MoE case: staggered
    lifetimes, 6 sequences in 8 padded slots, a budget under which both
    engines spill; the eager engine serves MoE one sequence a call, and
    its tokens are the reference eager engine's."""
    jcfg, cfg, params = _moe_case()
    prompts = _burst(cfg)
    eager, out_e = _serve_all(ServingEngine, cfg, params_from_jax(params),
                              prompts)
    comp, out_c = _serve_all(CompiledServingEngine, cfg,
                             params_from_jax(params), prompts)
    assert eager._prefill_batchable() is False
    assert comp._prefill_batchable() is True
    assert out_c == out_e
    assert eager.pool.stats.d2h_bytes > 0 and comp.pool.stats.d2h_bytes > 0
    ref = RefServing(jax_model_class(jcfg), jcfg, init_params=params,
                     device_memory_bytes=2_800_000,
                     host_memory_bytes=24_000_000, max_seq_len=24)
    rids = [ref.submit(p, n) for p, n in zip(prompts, _NEW_TOKENS)]
    ref.run()
    assert [ref.result(r) for r in rids] == out_e


def test_pooled_routing_in_the_compiled_round_drops_tokens(monkeypatch):
    """Why the round routes per slot: at a capacity factor of 0.5 a slot's
    own decode capacity (4) never drops its token, while 8 slots pooled
    share a capacity of 4 an expert for 16 assignments and drop some.
    Per-slot routing keeps the eager engine's tokens; pooled routing (the
    round's context patched back to the training one) changes them."""
    from repro_torch.models import moe

    jcfg, cfg, params = _moe_case(capacity_factor=0.5)
    prompts = _burst(cfg)
    _, out_e = _serve_all(ServingEngine, cfg, params_from_jax(params),
                          prompts)
    _, out_c = _serve_all(CompiledServingEngine, cfg,
                          params_from_jax(params), prompts)
    assert out_c == out_e
    dropped = []
    real = moe.dispatch_indices

    def spy(idx, e, c):
        out = real(idx, e, c)
        dropped.append(int((~out[1]).sum()))
        return out

    monkeypatch.setattr(moe, "dispatch_indices", spy)
    monkeypatch.setattr(ChunkedRuntime, "_row_ctx", lambda self: self.ctx)
    _, out_p = _serve_all(CompiledServingEngine, cfg,
                          params_from_jax(params), prompts)
    assert sum(dropped) > 0
    assert out_p != out_e
