"""The heavy arch-parametrised twins of the port's model zoo against the
JAX package, shared by the family files ``tests/test_torch_zoo_*.py``
(split out of ``tests/test_torch_zoo.py`` so no one file sets the
tier-1 run's wall under ``--dist loadfile``): the chunked-ZeRO runtime's
smoke train and decode, the eager trainer and the serving engine, each
against the reference on the same weights (see ``tests/test_torch_zoo.py``
for what each holds)."""

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
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import params_from_jax, stores_from_jax  # noqa: E402
from repro_torch.core.engine import PatrickStarEngine  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402


FP32 = dict(param_dtype="float32", compute_dtype="float32")
LOSS_TOL = 1e-5


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


def check_smoke_train_and_decode(arch):
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


def check_eager_trainer(arch):
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


def check_serving_engine(arch):
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
