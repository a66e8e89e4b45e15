"""The port's whisper backbone (``repro_torch.models.whisper``) against the
JAX package on the CPU, whisper-smoke (2 encoder + 2 decoder layers,
d 128, 4 heads of 32, 32 frames) in fp32, weights from
``_torch_parity.numpy_params`` through ``params_from_jax``, at frames =
tokens (2 x 32) and at fewer frames than tokens (32 frames, 2 x 48):

* ``WhisperBackbone``: the param tree, ``tp_axes``, the cache layouts,
  the loss and every gradient against ``jax.grad`` of the reference
  model's whole loss (1e-5);
* the eager trainer's step-1 gradients, every leaf, the encoder's and
  the frontend's included, against ``jax.grad`` under a budget that pages:
  its BWD differentiates ``between_groups`` at the encoder-decoder
  boundary (``PatrickStarEngine.backward_boundary``).  The reference's
  eager engine hands the decoder input's cotangent to the encoder and
  raises at fewer frames than tokens;
* the rank-parallel plane: p = 2 takes the single-rank engine's
  gradients and losses;
* the chunked runtime's serving steps on a (1, 1) mesh from the
  reference's own state: a prefill of the frames and a prompt, then
  greedy decode against the reference's ``prefill_step_fn`` and
  ``decode_step_fn`` (tokens identical, the fixed cross cache carried);
* the eager ``ServingEngine`` refuses the audio family, as the
  reference's does; a model without a boundary takes no boundary step.

The chunked runtime's training twin of ``tests/test_archs.py``'s smoke
case (dp = 2: losses and stores against the JAX runtime) is in
``tests/test_torch_zoo.py``, the cost model's audio terms in
``tests/test_torch_costmodel.py``.
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
from repro.models import layers as JL  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro.runtime.step import RuntimeOptions as JaxOptions  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import params_from_jax, stores_from_jax  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistributedPatrickStarEngine,
)
from repro_torch.core.engine import PatrickStarEngine  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.api import flatten_with_paths  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

ARCH = "whisper-large-v3"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-5
GRAD_TOL = 1e-4  # the eager trainer's: its sums run in another order
JCTX = JL.AxisCtx()
TCTX = TL.AxisCtx()
# (tokens, frames): frames = tokens, and fewer frames than tokens
CASES = {"frames_eq_tokens": (32, 32), "fewer_frames": (48, 32)}
BUDGET = dict(device_memory_bytes=1_500_000, policy="opt", lr=1e-3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL):
    """Within ``tol`` of each element and ``tol`` x the largest |want|."""
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(scale, 1.0e-30))


def _jitted(model_cls):
    """The reference model with its block groups' ``apply`` under
    ``jax.jit`` (the context static): its eager engine otherwise runs op
    by op and compiles hundreds of primitives."""
    class Jitted(model_cls):
        def groups(self):
            if not hasattr(self, "_jitted_groups"):
                self._jitted_groups = [dataclasses.replace(
                    g, apply=jax.jit(g.apply, static_argnums=3))
                    for g in super().groups()]
            return self._jitted_groups
    return Jitted


def _jflat(tree) -> dict:
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _layer(group, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in group.items()}


def _forward(model, ctx, params, batch, take):
    """embed, every group behind its ``between_groups``, the loss."""
    x, extras = model.embed(params["stem"], batch)
    for g in model.groups():
        x, extras = model.between_groups(g.name, x, extras, params["stem"],
                                         batch)
        for i in range(g.length):
            x, _ = g.apply(take(params["groups"][g.name], i), x, extras, ctx)
    return model.head_loss(params["stem"], x, batch)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these smoke-size tensors (restored)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke():
    """Both models, the weights, one [2, S] batch a case and ``jax.grad``
    of the reference model's whole loss on it (computed once)."""
    jcfg = jax_config(ARCH, smoke=True).replace(**FP32)
    cfg = get_config(ARCH, smoke=True).replace(**FP32)
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    jp = numpy_params(jm, 0)
    jtake = (lambda grp, i: jax.tree_util.tree_map(lambda t: t[i], grp))
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: _forward(jm, JCTX, p, b, jtake)))
    rng = np.random.default_rng(3)
    cases = {}
    for name, (s, f) in CASES.items():
        ids = rng.integers(0, cfg.vocab_size, (2, s))
        batch = {"frames": rng.standard_normal(
            (2, f, cfg.frontend_dim)).astype(np.float32), "tokens": ids,
            "labels": np.roll(ids, -1, 1),
            "global_tokens": np.float32(ids.size)}
        loss, grads = value_and_grad(
            jax.tree_util.tree_map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
        cases[name] = dict(batch=batch, loss=float(loss),
                           grads=_jflat(grads))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, tm=model_class(cfg)(cfg, TCTX),
                jp=jp, cases=cases)


@pytest.mark.parametrize("case", list(CASES))
def test_whisper_backbone_loss_and_gradients_match_the_reference(smoke,
                                                                  case):
    """The param tree (the stem's flat leaves beside ``embed``), the
    tp axes, the decoder's cache (its self k/v and the fixed cross cache
    of ``encoder_frames`` rows), the loss and every gradient: the
    encoder's reach the loss only through the decoder's cross-attention."""
    jm, tm = smoke["jm"], smoke["tm"]
    assert [g.name for g in tm.groups()] == ["encoder", "decoder"]
    assert tm.boundaries == ("decoder",)
    specs = jax.tree_util.tree_leaves_with_path(jm.param_specs())
    got = flatten_with_paths(tm.param_specs())
    assert [p for p, _ in got] == [tuple(k.key for k in p)
                                   for p, _ in specs]
    assert [tuple(t.shape) for _, t in got] == \
        [tuple(s.shape) for _, s in specs]
    assert tm.tp_axes() == jm.tp_axes()
    assert tm.groups()[0].init_cache is None
    mine = flatten_with_paths(tm.groups()[1].init_cache(2, 16))
    want = jax.tree_util.tree_leaves(jm.groups()[1].init_cache(2, 16))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for _, t in mine] == [(tuple(t.shape), str(t.dtype))
                                  for t in want]
    c = smoke["cases"][case]
    leaves = {p: t.clone().requires_grad_() for p, t in
              flatten_with_paths(params_from_jax(smoke["jp"]))}

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        return leaves[path]

    batch = {k: torch.as_tensor(v) for k, v in c["batch"].items()}
    loss = _forward(tm, TCTX, rebuild(params_from_jax(smoke["jp"])), batch,
                    _layer)
    loss.backward()
    assert abs(float(loss.detach()) - c["loss"]) <= TOL * abs(c["loss"])
    for path, t in leaves.items():
        _close(t.grad, c["grads"][path])
    for path in (("stem", "frontend_proj"), ("stem", "enc_pos"),
                 ("groups", "encoder", "attn", "wq")):
        assert float(leaves[path].grad.abs().max()) > 0, path


def _engine_grads(eng, batch) -> dict:
    """One step's FWD and BWD phases (the boundary step included, as
    ``step`` drives it), then every gradient: the stem's and each
    layer's, which overwrote its param payload, stacked per group."""
    st = eng.begin_step(batch)
    eng.forward_embed(st)
    for g in eng.model.groups():
        eng.forward_group_start(st, g.name)
        for i in range(g.length):
            eng.forward_layer(st, g, i)
    eng.end_forward(st)
    eng.begin_backward(st)
    for idx in range(len(st.saved) - 1, -1, -1):
        eng.backward_layer(st, idx)
        eng.backward_boundary(st, idx)
    eng.backward_embed(st)
    out = {("stem",) + p: g.clone()
           for p, g in zip(eng._stem_paths, st.stem_grad)}
    for g in eng.model.groups():
        layers = [[eng.params_mgr.tensor_view(n).clone() for n in names]
                  for names in eng._group_tensor_names[g.name]]
        for j, path in enumerate(eng._layer_paths[g.name]):
            out[("groups", g.name) + path] = torch.stack(
                [lay[j] for lay in layers])
    return out, st


@pytest.mark.parametrize("case", list(CASES))
def test_eager_trainer_gradients_match_jax_grad(smoke, case):
    """Step 1 of the port's eager trainer (OPT, prefetch, the act stream,
    a budget that pages): every leaf's gradient equals ``jax.grad`` of the
    whole loss.  The encoder's output is checkpointed in the act stream
    when its numel is the stream's (frames = tokens) and held live
    otherwise, the decoder's inputs likewise (the reference's rule)."""
    cfg = smoke["cfg"]
    c = smoke["cases"][case]
    eng = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                            init_params=params_from_jax(smoke["jp"]),
                            **BUDGET)
    got, st = _engine_grads(eng, c["batch"])
    assert set(got) == set(c["grads"])
    for path, want in c["grads"].items():
        _close(got[path], want, GRAD_TOL)
    s, f = CASES[case]
    assert len(eng.act_cmap.placements) == 1 + 2 + 2  # entry + layers
    act = [type(saved).__name__ for _, _, saved in st.saved]
    assert act == ["_ActRef"] * 2 + (["_ActRef"] * 2 if s == f
                                     else ["Tensor"] * 2)
    eng.end_backward(st)
    assert eng.tenant.stats.h2d_bytes > 0  # the budget pages


def test_reference_eager_trainer_fails_at_the_boundary(smoke):
    """The reference's eager engine (``src/repro/core/engine.py``) hands
    the decoder input's cotangent [2, 48, d] straight to the encoder's
    last layer, whose output is [2, 32, d]: at fewer frames than tokens
    its BWD raises, where the port's gradients match ``jax.grad``
    (the test above)."""
    jcfg = smoke["jcfg"]
    c = smoke["cases"]["fewer_frames"]
    ref = RefEngine(_jitted(jax_model_class(jcfg)), jcfg,
                    init_params=smoke["jp"], **BUDGET)
    with pytest.raises(ValueError, match=r"\[2,32,128\]"):
        ref.step(c["batch"])


def test_rank_parallel_plane_takes_the_same_gradients(smoke):
    """p = 2 (the batch, frames included, split over two simulated
    ranks): the stem gradient handed to the first update (the frontend,
    the positions, the encoder norm and the token embedding, each through
    the boundary) equals the single-rank engine's, and the losses of 2
    steps agree."""
    cfg = smoke["cfg"]
    batch = smoke["cases"]["fewer_frames"]["batch"]
    params = params_from_jax(smoke["jp"])
    seen = {}

    def capture(core, key):
        orig = core.update_stem

        def wrapped(stem_grad):
            seen.setdefault(key, [g.clone() for g in stem_grad])
            return orig(stem_grad)
        core.update_stem = wrapped

    kw = dict(device="cpu", init_params=params, **BUDGET)
    one = PatrickStarEngine(model_class(cfg), cfg, **kw)
    two = DistributedPatrickStarEngine(model_class(cfg), cfg, nproc=2, **kw)
    capture(one, "one")
    capture(two.ranks[0], "two")
    losses = [(one.step(batch).loss, two.step(batch).loss)
              for _ in range(2)]
    for a, b in losses:
        assert abs(a - b) <= TOL * abs(a), losses
    for path, a, b in zip(one._stem_paths, seen["one"], seen["two"]):
        _close(b, a, GRAD_TOL)
        assert float(b.abs().max()) > 0, path
    two.check_invariants()


def test_prefill_and_decode_match_the_reference_runtime(smoke):
    """The runtime's serving steps on a (1, 1) mesh from the reference's
    own state: a prefill of 32 frames and a 12-token prompt (its logits
    within 1e-5 of the reference's, the cross cache [1, 2, B, 32, 4, 32]
    beside the self cache), the caches grown to a 16-position horizon
    (the cross cache untouched), then 4 greedy decode steps: tokens
    identical, the encoder skipped (it has no decode)."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(1, 1),
                     JaxOptions())
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(1, 1, device="cpu"), RuntimeOptions())
    jps, jos = jax_driver.init_state(jrt, jax.random.key(0))
    ps, _ = driver.place_state(rt, *stores_from_jax(jax.device_get(jps),
                                                    jax.device_get(jos)))
    b, p, h = 4, 12, 16
    rng = np.random.default_rng(4)
    batch = {"frames": rng.standard_normal(
        (b, cfg.encoder_frames, cfg.frontend_dim)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (b, p))}
    pre, (_, bspecs) = driver.build_prefill_step(
        rt, InputShape("p", p, b, "prefill"))
    assert tuple(bspecs["frames"].shape) == (b, 32, cfg.frontend_dim)
    jpre, _ = jax_driver.build_prefill_step(jrt, JaxShape("p", p, b,
                                                          "prefill"))
    logits, caches = pre(ps, batch)
    jlogits, jcaches = jpre(jps, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    _close(logits, jlogits)
    assert list(caches) == ["decoder"]
    cross = caches["decoder"]["cross"]["k"]
    assert tuple(cross.shape) == (1, 2, b, 32, 4, 32)
    dshape = InputShape("d", h, b, "decode")
    caches = driver.grow_caches(rt, caches, p, h, dshape)
    assert caches["decoder"]["cross"]["k"] is cross
    assert tuple(caches["decoder"]["self"]["k"].shape) == (1, 2, b, h, 4, 32)
    jcaches = jax_driver.grow_caches(jrt, jcaches, p, h,
                                     JaxShape("d", h, b, "decode"))
    dec, _ = driver.build_decode_step(rt, dshape)
    jdec, _ = jax_driver.build_decode_step(jrt, JaxShape("d", h, b,
                                                         "decode"))
    tok = logits.argmax(-1)
    jtok = jnp.argmax(jlogits, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for pos in range(p, p + 4):
        tok, caches = dec(ps, caches, tok.reshape(b, 1), pos)
        jtok, jcaches = jdec(jps, jcaches, jnp.asarray(jtok).reshape(b, 1),
                             jnp.int32(pos))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for (_, a), w in zip(flatten_with_paths(caches["decoder"]),
                         jax.tree_util.tree_leaves(jcaches["decoder"])):
        _close(a, w)


def test_serving_engine_refuses_audio(smoke):
    """The eager (and so the compiled) ``ServingEngine`` serves token
    prompts: both packages refuse an encoder-input arch with the same
    message."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    kw = dict(device_memory_bytes=1_500_000, max_seq_len=16)
    with pytest.raises(ValueError, match="modality front-end") as want:
        RefServing(jax_model_class(jcfg), jcfg, init_params=smoke["jp"],
                   **kw)
    with pytest.raises(ValueError, match="modality front-end") as got:
        ServingEngine(model_class(cfg), cfg, device="cpu",
                      init_params=params_from_jax(smoke["jp"]), **kw)
    assert str(got.value) == str(want.value)


def test_no_boundary_no_boundary_step():
    """A model whose ``between_groups`` is the identity everywhere (the
    dense family) declares no boundary: the BWD piece returns at once and
    leaves the cotangent it was given as it was."""
    cfg = get_config("gpt2-paper-1b", smoke=True).replace(num_layers=2,
                                                          **FP32)
    eng = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                            device_memory_bytes=4_000_000)
    assert eng.model.boundaries == ()
    batch = {k: v for k, v in make_batch_fn(cfg, 2, 16)().items()
             if k != "mask"}
    st = eng.begin_step(batch)
    eng.forward_embed(st)
    for g in eng.model.groups():
        eng.forward_group_start(st, g.name)
        for i in range(g.length):
            eng.forward_layer(st, g, i)
    eng.begin_backward(st)
    assert st.entries == {}
    for idx in range(len(st.saved) - 1, -1, -1):
        eng.backward_layer(st, idx)
        gx, stem = st.gx, list(st.stem_grad)
        eng.backward_boundary(st, idx)
        assert st.gx is gx and all(a is b for a, b in
                                   zip(st.stem_grad, stem))


def test_modality_batches():
    """The twin of ``tests/test_substrate.py::test_modality_batches
    [whisper-large-v3]``: the port's pipeline adds the stub frames, and
    its runtime's batch specs name them, split like the tokens."""
    cfg = get_config(ARCH, smoke=True)
    b = make_batch_fn(cfg, 2, 48)()
    assert b["frames"].shape == (2, 32, cfg.frontend_dim)
    assert b["frames"].dtype == np.float32
    assert b["tokens"].shape == (2, 48)
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(2, 1, device="cpu"), RuntimeOptions())
    specs, pspecs, n = driver.train_batch_specs(rt, InputShape("t", 48, 2,
                                                               "train"))
    assert tuple(specs["frames"].shape) == (2, 32, cfg.frontend_dim)
    assert pspecs["frames"] == (("data",), None, None)
    assert pspecs["tokens"] == (("data",), None) and n == 96.0
