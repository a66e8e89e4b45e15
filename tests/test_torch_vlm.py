"""The port's phi-3-vision backbone (``repro_torch.models.vlm``) against the
JAX package on the CPU, phi3v-smoke (2 layers, d 128, 4 heads of 32, 16
stub patches of width 64 ahead of the text) in fp32, weights from
``_torch_parity.numpy_params`` through ``params_from_jax``, batches of
2 x (16 patches + 48 tokens):

* ``VLMBackbone``: the param tree (the projector beside the dense stem),
  ``tp_axes``, ``embed`` (projector, tanh GELU, patches ahead of the
  tokens), ``head_loss`` on the text positions only, the loss and every
  gradient, the projector's included, against ``jax.grad`` of the
  reference model's whole loss (1e-5);
* the eager trainer: its steps against the reference's eager trainer
  (losses within 1e-5, every counter identical, the transfer timeline
  field for field: both price the text length only), and its step-1
  gradients, every leaf, against ``jax.grad`` (the projector's through
  ``backward_embed``'s VJP of ``embed``);
* the rank-parallel plane: p = 2 takes the single-rank engine's stem
  gradients and losses;
* the chunked runtime's serving steps on a (1, 1) mesh from the
  reference's own state: a prefill of the patches and a prompt, then
  greedy decode (positions count the patches too) against the
  reference's ``prefill_step_fn`` and ``decode_step_fn``;
* the eager ``ServingEngine`` refuses the vlm family, as the
  reference's does; the pipeline's patch batches and the runtime's batch
  specs (the twin of ``tests/test_substrate.py::test_modality_batches
  [phi-3-vision-4.2b]``).

The runtime's training twin of ``tests/test_archs.py``'s smoke case
(dp = 2: losses against the JAX runtime, then a decode) and the CLI are
in ``tests/test_torch_zoo.py``, the cost model's vlm terms in
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
from repro.core.timeline import TransferTimeline as RefTimeline  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jax_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro.runtime.step import RuntimeOptions as JaxOptions  # noqa: E402
from _torch_parity import (  # noqa: E402
    numpy_params,
    reference_hardware,
    timeline_fields,
)
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import params_from_jax, stores_from_jax  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistributedPatrickStarEngine,
)
from repro_torch.core.engine import PatrickStarEngine  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.core.timeline import TransferTimeline  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.api import flatten_with_paths  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

ARCH = "phi-3-vision-4.2b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-5
GRAD_TOL = 1e-4  # the eager trainer's: its sums run in another order
JCTX = JL.AxisCtx()
TCTX = TL.AxisCtx()
B, TEXT = 2, 48  # batch rows and text tokens a row (16 patches ahead)
BUDGET = dict(device_memory_bytes=1_500_000, policy="opt", lr=1e-3)
COUNTERS = ("h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes", "prefetch_hits",
            "demand_misses", "peak_device_bytes")


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
    """The reference model with its block group's ``apply``, ``prefill``
    and ``decode`` under ``jax.jit`` (the context static): its eager
    engine otherwise runs op by op and compiles hundreds of primitives."""
    class Jitted(model_cls):
        def groups(self):
            if not hasattr(self, "_jitted_groups"):
                self._jitted_groups = [dataclasses.replace(
                    g, apply=jax.jit(g.apply, static_argnums=3),
                    prefill=jax.jit(g.prefill, static_argnums=3),
                    decode=jax.jit(g.decode, static_argnums=5))
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
    """embed, every layer, the loss."""
    x, extras = model.embed(params["stem"], batch)
    for g in model.groups():
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
    """Both models, the weights, three [2, 16 + 48] batches (the pipeline's:
    patches, tokens, labels) and ``jax.grad`` of the reference model's
    whole loss on the first (computed once)."""
    jcfg = jax_config(ARCH, smoke=True).replace(**FP32)
    cfg = get_config(ARCH, smoke=True).replace(**FP32)
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    jp = numpy_params(jm, 0)
    nxt = make_batch_fn(cfg, B, cfg.num_patches + TEXT, seed=3)
    batches = [{k: v for k, v in nxt().items() if k != "mask"}
               for _ in range(3)]
    jtake = (lambda grp, i: jax.tree_util.tree_map(lambda t: t[i], grp))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: _forward(jm, JCTX, p, b, jtake)))(
            jax.tree_util.tree_map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in batches[0].items()})
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, tm=model_class(cfg)(cfg, TCTX),
                jp=jp, batches=batches, loss=float(loss),
                grads=_jflat(grads))


def test_vlm_embed_and_head_match_the_reference(smoke):
    """The param tree (the projector's w1 [vision_dim, d] and w2 [d, d] in
    the stem), ``tp_axes`` (the projector replicated), ``embed`` (the
    projected patches ahead of the token embeddings) and ``head_loss``,
    which reads the text positions only: the patches' hidden states do
    not move it."""
    jm, tm, cfg = smoke["jm"], smoke["tm"], smoke["cfg"]
    assert model_class(get_config(ARCH)).__name__ == "VLMBackbone"
    specs = jax.tree_util.tree_leaves_with_path(jm.param_specs())
    got = flatten_with_paths(tm.param_specs())
    assert [p for p, _ in got] == [tuple(k.key for k in p)
                                   for p, _ in specs]
    assert [tuple(t.shape) for _, t in got] == \
        [tuple(s.shape) for _, s in specs]
    assert tm.tp_axes() == jm.tp_axes()
    assert tm.tp_axes()["stem"]["projector"] == {"w1": None, "w2": None}
    params = params_from_jax(smoke["jp"])
    batch = smoke["batches"][0]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    x, extras = tm.embed(params["stem"], tb)
    jx, _ = jm.embed(smoke["jp"]["stem"], jb)
    assert extras is None
    assert tuple(x.shape) == (B, cfg.num_patches + TEXT, cfg.d_model)
    _close(x, jx)
    # the text positions are the token embeddings themselves
    _close(x[:, cfg.num_patches:],
           params["stem"]["embed"]["table"][tb["tokens"]])
    loss = tm.head_loss(params["stem"], x, tb)
    want = jm.head_loss(smoke["jp"]["stem"], jx, jb)
    assert abs(float(loss) - float(want)) <= TOL * abs(float(want))
    y = x.clone()
    y[:, :cfg.num_patches] = 7.0
    assert float(tm.head_loss(params["stem"], y, tb)) == float(loss)


def test_vlm_loss_and_gradients_match_jax_grad(smoke):
    """The whole loss and every gradient, the projector's included,
    against ``jax.grad`` of the reference model's (1e-5)."""
    tm = smoke["tm"]
    leaves = {p: t.clone().requires_grad_() for p, t in
              flatten_with_paths(params_from_jax(smoke["jp"]))}

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        return leaves[path]

    batch = {k: torch.as_tensor(v) for k, v in smoke["batches"][0].items()}
    loss = _forward(tm, TCTX, rebuild(params_from_jax(smoke["jp"])), batch,
                    _layer)
    loss.backward()
    assert abs(float(loss.detach()) - smoke["loss"]) <= TOL * smoke["loss"]
    assert set(leaves) == set(smoke["grads"])
    for path, t in leaves.items():
        _close(t.grad, smoke["grads"][path])
    for path in (("stem", "projector", "w1"), ("stem", "projector", "w2")):
        assert float(leaves[path].grad.abs().max()) > 0, path


def _engine_grads(eng, batch) -> dict:
    """One step's FWD and BWD phases, then every gradient: the stem's and
    each layer's (which overwrote its param payload), stacked."""
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
    eng.end_backward(st)
    return out


def test_eager_trainer_gradients_match_jax_grad(smoke):
    """Step 1 of the port's eager trainer (OPT, prefetch, the act stream,
    a budget that pages): every leaf's gradient equals ``jax.grad`` of the
    whole loss, the projector's through ``backward_embed``'s VJP of
    ``embed``."""
    cfg = smoke["cfg"]
    eng = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                            init_params=params_from_jax(smoke["jp"]),
                            **BUDGET)
    got = _engine_grads(eng, smoke["batches"][0])
    assert set(got) == set(smoke["grads"])
    for path, want in smoke["grads"].items():
        _close(got[path], want, GRAD_TOL)
    assert float(got[("stem", "projector", "w1")].abs().max()) > 0
    assert eng.tenant.stats.h2d_bytes > 0  # the budget pages


def test_eager_trainer_and_its_timeline_match_the_reference(smoke):
    """Three steps of both eager trainers with a finite-bandwidth transfer
    timeline priced on the same constants: losses within 1e-5, every
    counter and every ``StepTimeline`` field identical.  Both price the
    step from ``tokens.shape`` (the reference's ``_batch_tokens_shape``):
    the text length only, without the 16 patch positions."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    bw = dict(h2d_bandwidth=1e8, d2h_bandwidth=1e8)
    ref = RefEngine(_jitted(jax_model_class(jcfg)), jcfg,
                    init_params=smoke["jp"], timeline=RefTimeline(**bw),
                    **BUDGET)
    port = PatrickStarEngine(
        model_class(cfg), cfg, device="cpu",
        init_params=params_from_jax(smoke["jp"]),
        timeline=TransferTimeline(hardware=reference_hardware(), **bw),
        **BUDGET)
    for i, batch in enumerate(smoke["batches"]):
        a, b = ref.step(batch), port.step(batch)
        assert abs(a.loss - b.loss) <= TOL * abs(a.loss), (i, a.loss, b.loss)
        assert {f: getattr(b, f) for f in COUNTERS} == \
            {f: getattr(a, f) for f in COUNTERS}, i
        assert timeline_fields(b.timeline) == timeline_fields(a.timeline), i
    assert port._batch_tokens_shape == ref._batch_tokens_shape == (B, TEXT)
    assert b.timeline.compute_s > 0 and b.timeline.stall_s > 0
    port.pool.check_invariants()


def test_rank_parallel_plane_takes_the_same_gradients(smoke):
    """p = 2 (the batch, patches included, split over two simulated
    ranks): the stem gradient handed to the first update (the projector
    and the token embedding) equals the single-rank engine's, and the
    losses of 2 steps agree."""
    cfg = smoke["cfg"]
    batch = smoke["batches"][0]
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
    own state: a prefill of 16 patches and a 12-token prompt (a
    28-position sequence; its logits within 1e-5 of the reference's, the
    caches [1, 2, B, 28, 4, 32]), the caches grown to a 32-position
    horizon, then 4 greedy decode steps from position 28: tokens
    identical, the caches equal."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    jrt = JaxRuntime(_jitted(jax_model_class(jcfg)), jcfg, jax_mesh(1, 1),
                     JaxOptions())
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(1, 1, device="cpu"), RuntimeOptions())
    jps, jos = jax_driver.init_state(jrt, jax.random.key(0))
    ps, _ = driver.place_state(rt, *stores_from_jax(jax.device_get(jps),
                                                    jax.device_get(jos)))
    b, p, h = 4, 12, 32
    s = cfg.num_patches + p
    rng = np.random.default_rng(4)
    batch = {"patch_embeds": rng.standard_normal(
        (b, cfg.num_patches, cfg.vision_dim)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (b, p))}
    pre, (_, bspecs) = driver.build_prefill_step(
        rt, InputShape("p", s, b, "prefill"))
    assert tuple(bspecs["tokens"].shape) == (b, p)
    assert tuple(bspecs["patch_embeds"].shape) == (b, cfg.num_patches,
                                                   cfg.vision_dim)
    jpre, _ = jax_driver.build_prefill_step(jrt, JaxShape("p", s, b,
                                                          "prefill"))
    logits, caches = pre(ps, batch)
    jlogits, jcaches = jpre(jps, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    _close(logits, jlogits)
    assert tuple(caches["layers"]["k"].shape) == (1, 2, b, s, 4, 32)
    dshape = InputShape("d", h, b, "decode")
    caches = driver.grow_caches(rt, caches, s, h, dshape)
    jcaches = jax_driver.grow_caches(jrt, jcaches, s, h,
                                     JaxShape("d", h, b, "decode"))
    dec, _ = driver.build_decode_step(rt, dshape)
    jdec, _ = jax_driver.build_decode_step(jrt, JaxShape("d", h, b,
                                                         "decode"))
    tok = logits.argmax(-1)
    jtok = jnp.argmax(jlogits, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for pos in range(s, s + 4):
        tok, caches = dec(ps, caches, tok.reshape(b, 1), pos)
        jtok, jcaches = jdec(jps, jcaches, jnp.asarray(jtok).reshape(b, 1),
                             jnp.int32(pos))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for (_, a), w in zip(flatten_with_paths(caches["layers"]),
                         jax.tree_util.tree_leaves(jcaches["layers"])):
        _close(a, w)
    with pytest.raises(ValueError, match="patch_embeds"):
        pre(ps, dict(batch, patch_embeds=batch["patch_embeds"][:, :8]))


def test_serving_engine_refuses_vlm(smoke):
    """The eager (and so the compiled) ``ServingEngine`` serves token
    prompts: both packages refuse a patch-input arch with the same
    message."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    kw = dict(device_memory_bytes=1_500_000, max_seq_len=32)
    with pytest.raises(ValueError, match="modality front-end") as want:
        RefServing(jax_model_class(jcfg), jcfg, init_params=smoke["jp"],
                   **kw)
    with pytest.raises(ValueError, match="modality front-end") as got:
        ServingEngine(model_class(cfg), cfg, device="cpu",
                      init_params=params_from_jax(smoke["jp"]), **kw)
    assert str(got.value) == str(want.value)


def test_patch_batches():
    """The twin of ``tests/test_substrate.py::test_modality_batches
    [phi-3-vision-4.2b]``: the port's pipeline adds the stub patches and
    cuts the text to ``S - num_patches``; its runtime's batch specs name
    them, split like the tokens, count the text tokens only, and refuse a
    sequence that leaves no text."""
    cfg = get_config(ARCH, smoke=True)
    b = make_batch_fn(cfg, 2, 48)()
    assert b["patch_embeds"].shape == (2, cfg.num_patches, cfg.vision_dim)
    assert b["patch_embeds"].dtype == np.float32
    assert b["tokens"].shape == b["labels"].shape == (2, 48 - 16)
    assert float(b["global_tokens"]) == 2 * (48 - 16)
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(2, 1, device="cpu"), RuntimeOptions())
    specs, pspecs, n = driver.train_batch_specs(rt, InputShape("t", 48, 2,
                                                               "train"))
    assert tuple(specs["patch_embeds"].shape) == (2, 16, cfg.vision_dim)
    assert tuple(specs["tokens"].shape) == (2, 32)
    assert pspecs["patch_embeds"] == (("data",), None, None)
    assert pspecs["tokens"] == (("data",), None) and n == 64.0
    with pytest.raises(ValueError, match="no text"):
        driver.train_batch_specs(rt, InputShape("t", 16, 2, "train"))
