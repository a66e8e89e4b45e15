"""The runtime's serving steps at tp = 2 against the reference's on the
CPU: whisper and phi-3-vision after a training step (``tests/_torch_tp.py``;
qwen2.5's "dist" cache and the dp 2 x tp 2 serving twin are in
``test_torch_tp_dist.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import InputShape as JaxShape  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import stores_from_jax  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402

import _torch_tp as H  # noqa: E402

B, S = H.B, H.S


@pytest.mark.parametrize("arch", ["whisper-large-v3", "phi-3-vision-4.2b"])
def test_frontend_families_tp2_step_then_serve(arch):
    """whisper (the encoder-decoder, the cross-attention's per-rank
    cache) and phi-3-vision (projected patches ahead of the text) at
    tp = 2: one step against the reference's, then a prefill and 4 greedy
    decode steps from the updated stores: logits and every cache leaf
    rank by rank within 1e-4, tokens identical."""
    jrt, rt = H.runtimes(arch, 1, 2)
    H.oracle_scale(jrt, 2)
    cfg = rt.cfg
    s_train = S + (cfg.num_patches if cfg.arch_type == "vlm" else 0)
    (ps, oss), (tps, tos) = H.start(jrt, rt)
    nxt = make_batch_fn(cfg, B, s_train, seed=3)
    batch = nxt()
    batch.pop("mask")
    jstep, _, _ = jax_driver.build_train_step(
        jrt, JaxShape("t", s_train, B, "train"))
    step, _, _ = driver.build_train_step(rt, InputShape("t", s_train, B,
                                                        "train"))
    ps, oss, jm = jstep(ps, oss, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jnp.int32(0))
    tps, tos, m = step(tps, tos, batch, 0)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    H.check_stores(stores_from_jax(jax.device_get(ps), jax.device_get(oss)),
                  (tps, tos), 1)
    rng = np.random.default_rng(4)
    b, s = 2, 12
    serve = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.arch_type == "audio":
        serve["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.frontend_dim)).astype(np.float32)
    if cfg.arch_type == "vlm":
        serve["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
        s += cfg.num_patches
    jserve = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
              for k, v in serve.items()}
    H.check_serving(H.serve_both(jrt, rt, ps, tps, serve, jserve, s))
