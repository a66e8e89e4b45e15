"""The port's zamba2 hybrid (``repro_torch.models.zamba``) against the JAX
package on the CPU, zamba2-smoke (5 mamba layers: 2 units of 2 and a
1-layer tail, d 128, the shared block 256 wide, ``chunk_len`` 16; cut to
3 layers, one unit and the tail, where the reference runs op by op or
compiles the whole model) in fp32, weights from
``_torch_parity.numpy_params`` through ``params_from_jax``:

* ``ZambaLM``: the param tree, the cache layouts, the loss and every
  gradient against ``jax.grad`` of the reference model's whole loss
  (1e-5 relative on the loss), prefill and decode against the
  reference's, and the per-row decode (a [B] position tensor) equal to
  each row alone with every cache leaf written in place;
* the eager trainer's step-1 gradients, every leaf, the shared block in
  the stem and the embedding included, against ``jax.grad`` of the whole
  loss; the reference's eager engine gives the shared block a zero
  gradient there (it closes over the extras); the rank-parallel plane
  (p = 2) gives the single-rank engine's gradients;
* eager serving: greedy tokens and every per-round counter equal the
  reference engine's under a budget that pages; paged KV raises in both
  packages (the SSM state has no position axis); the compiled round
  against the eager engine one sequence a decode call (tokens and
  counters) — the twin of the reference's ``@slow``
  ``tests/test_compiled_serving.py::test_compiled_round_matches_eager_zamba``;
* the chunked runtime on a (dp=2, tp=1) mesh: 3 steps against the JAX
  runtime from one state, losses within 1e-5 relative, then a decode.
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
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.api import flatten_with_paths, tree_map  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.serve import CompiledServingEngine  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

ARCH = "zamba2-1.2b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-5
GRAD_TOL = 1e-4  # absolute and relative, per element
JCTX = JL.AxisCtx()
TCTX = TL.AxisCtx()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL):
    """Within ``tol`` of each element and ``tol`` x the largest |want|:
    through five layers, a sum's order moves an element near zero by a
    few 1e-6 of the activations' scale."""
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(scale, 1.0))


def _jtree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _unflat(group, i):
    return {k: (_unflat(v, i) if isinstance(v, dict) else v[i])
            for k, v in group.items()}


def _jitted(model_cls):
    """The reference model with its block groups' ``apply``, ``prefill``
    and ``decode`` under ``jax.jit`` (the context static), built once: its
    engines otherwise run op by op and compile hundreds of primitives."""
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these smoke-size tensors: the suite runs
    several workers on the machine's cores, where idle pool threads only
    contend (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke():
    """Both models, the weights, a [2, 40] batch and ``jax.grad`` of the
    reference model's whole loss (computed once)."""
    jcfg = jax_config(ARCH, smoke=True).replace(**FP32)
    cfg = get_config(ARCH, smoke=True).replace(**FP32)
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    tm = model_class(cfg)(cfg, TCTX)
    jp = numpy_params(jm, 0)
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24))
    batch = {"tokens": ids, "labels": np.roll(ids, -1, 1),
             "global_tokens": np.float32(ids.size)}

    def jloss(params):
        x, extras = jm.embed(params["stem"], {"tokens": jnp.asarray(ids)})
        for g in jm.groups():
            for i in range(g.length):
                x, _ = g.apply(jax.tree_util.tree_map(
                    lambda t, _i=i: t[_i], params["groups"][g.name]), x,
                    extras, JCTX)
        return jm.head_loss(params["stem"], x, {
            k: jnp.asarray(v) for k, v in batch.items()})

    jl, jg = jax.jit(jax.value_and_grad(jloss))(_jtree(jp))
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, tm=tm, jp=jp, batch=batch,
                loss=float(jl), grads=_jflat(jg))


@pytest.fixture(scope="module")
def short():
    """zamba2-smoke cut to 3 layers (one unit of 2 and a 1-layer tail:
    both groups), its numpy weights and a [2, 16] batch: the serving, the
    runtime and the rank-parallel cases, whose reference runs op by op or
    compiles the whole model."""
    jcfg = jax_config(ARCH, smoke=True).replace(num_layers=3, **FP32)
    cfg = get_config(ARCH, smoke=True).replace(num_layers=3, **FP32)
    ids = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 16))
    return dict(jcfg=jcfg, cfg=cfg, jp=numpy_params(
        jax_model_class(jcfg)(jcfg, JCTX), 1), batch={
            "tokens": ids, "labels": np.roll(ids, -1, 1),
            "global_tokens": np.float32(ids.size)})


def test_zamba_lm_loss_and_gradients_match_the_reference(smoke):
    """The param tree (the shared block in the stem, the units' mamba
    layers stacked [2, ...], the tail), the cache layouts, the loss and
    every gradient: the shared block's sums over both units, x0's over
    both units' concat."""
    cfg, jm, tm = smoke["cfg"], smoke["jm"], smoke["tm"]
    assert [g.name for g in tm.groups()] == ["units", "tail"]
    specs = jax.tree_util.tree_leaves_with_path(jm.param_specs())
    got = flatten_with_paths(tm.param_specs())
    assert [tuple(t.shape) for _, t in got] == \
        [tuple(s.shape) for _, s in specs]
    assert [t.dtype for _, t in got] == \
        [torch.float32] * len(got)
    assert sorted(tm.param_specs()["stem"]) == ["embed", "final_norm",
                                                "shared_attn"]
    for g, jg in zip(tm.groups(), jm.groups()):
        mine = flatten_with_paths(g.init_cache(1, 16))
        want = jax.tree_util.tree_leaves(jg.init_cache(1, 16))
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                for _, t in mine] == \
            [(tuple(t.shape), str(t.dtype)) for t in want]
    tp = params_from_jax(smoke["jp"])
    leaves = {p: t.clone().requires_grad_() for p, t in
              flatten_with_paths(tp)}

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        return leaves[path]

    params = rebuild(tp)
    ids = smoke["batch"]["tokens"]
    x, extras = tm.embed(params["stem"], {"tokens": torch.from_numpy(ids)})
    for g in tm.groups():
        for i in range(g.length):
            x, _ = g.apply(_unflat(params["groups"][g.name], i), x, extras,
                           TCTX)
    loss = tm.head_loss(params["stem"], x, {
        k: torch.as_tensor(v) for k, v in smoke["batch"].items()})
    loss.backward()
    assert abs(float(loss.detach()) - smoke["loss"]) <= TOL * abs(smoke["loss"])
    for path, t in leaves.items():
        _close(t.grad, smoke["grads"][path], GRAD_TOL)
    assert float(leaves[("stem", "shared_attn", "attn", "wq")].grad
                 .abs().max()) > 0


def _prefill(model, ctx, params, stem, ids, unflat):
    x, extras = model.embed(stem, {"tokens": ids})
    caches = {}
    for g in model.groups():
        ys = []
        for i in range(g.length):
            x, c = g.prefill(unflat(params["groups"][g.name], i), x,
                             extras, ctx)
            ys.append(c)
        caches[g.name] = ys
    return x, caches


def test_prefill_and_decode_match_the_reference(smoke):
    """Prefill 12 tokens into 16-position caches, then 3 decode steps at
    int positions: hidden states, head logits and every cache leaf (the
    shared block's k/v, the units' stacked mamba states, the tail's)
    against the reference's."""
    jcfg, cfg, jm, tm = smoke["jcfg"], smoke["cfg"], smoke["jm"], smoke["tm"]
    jp, tp = _jtree(smoke["jp"]), params_from_jax(smoke["jp"])
    ids = smoke["batch"]["tokens"][:, :12]
    jtake = (lambda grp, i: jax.tree_util.tree_map(lambda t: t[i], grp))
    tx, tcs = _prefill(tm, TCTX, tp, tp["stem"], torch.from_numpy(ids),
                       _unflat)
    jx, jcs = jax.jit(lambda p, i: _prefill(jm, JCTX, p, p["stem"], i,
                                            jtake))(jp, jnp.asarray(ids))
    _close(tx, jx)

    def grow(c, jgrow):
        # the prefill's k/v ([B, 12, ...]) into a 16-position cache
        if jgrow:
            return jax.tree_util.tree_map(
                lambda t: jnp.pad(t, [(0, 0), (0, 4), (0, 0), (0, 0)])
                if t.ndim == 4 and t.shape[1] == 12 else t, c)
        return tree_map(lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0,
                                                              0, 4))
                        if t.ndim == 4 and t.shape[1] == 12 else t, c)

    tcs = {n: [grow(c, False) for c in cs] for n, cs in tcs.items()}
    jcs = {n: [grow(c, True) for c in cs] for n, cs in jcs.items()}
    for n in tcs:
        for tc, jc in zip(tcs[n], jcs[n]):
            for (_, a), b in zip(flatten_with_paths(tc),
                                 jax.tree_util.tree_leaves(jc)):
                _close(a, b)
    def jdecode(p, tok, caches, pos):
        x = jm.embed_decode(p["stem"], tok, pos, None)
        extras = jm.decode_extras(p["stem"], x)
        hs, new = [], {}
        for jg in jm.groups():
            new[jg.name] = []
            for i in range(jg.length):
                x, c = jg.decode(jtake(p["groups"][jg.name], i), x,
                                 caches[jg.name][i], pos, extras, JCTX)
                hs.append(x)
                new[jg.name].append(c)
        return hs, jm.head_logits(p["stem"], x), new

    jdecode = jax.jit(jdecode)
    tok = ids[:, -1:]
    for pos in range(12, 15):
        jhs, jl, jcs = jdecode(jp, jnp.asarray(tok), jcs, jnp.int32(pos))
        tx = tm.embed_decode(tp["stem"], torch.from_numpy(tok), pos, None)
        te = tm.decode_extras(tp["stem"], tx)
        k = 0
        for g in tm.groups():
            for i in range(g.length):
                tx, tcs[g.name][i] = g.decode(
                    _unflat(tp["groups"][g.name], i), tx, tcs[g.name][i],
                    pos, te, TCTX)
                _close(tx, jhs[k])
                k += 1
        _close(tm.head_logits(tp["stem"], tx), jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl, -1))
    for n in tcs:
        for tc, jc in zip(tcs[n], jcs[n]):
            for (_, a), b in zip(flatten_with_paths(tc),
                                 jax.tree_util.tree_leaves(jc)):
                _close(a, b)


def test_per_row_decode_equals_each_row_alone(smoke):
    """A [B] position tensor (the compiled round's slots, rows at
    different positions): the unit and tail caches are written in place
    and returned, and each row equals an int-position decode of that row
    alone."""
    cfg, tm = smoke["cfg"], smoke["tm"]
    tp = params_from_jax(smoke["jp"])
    rng = np.random.default_rng(5)
    stem = tp["stem"]
    for g in tm.groups():
        p = _unflat(tp["groups"][g.name], 0)
        cache = tree_map(lambda t: torch.from_numpy(rng.standard_normal(
            tuple(t.shape)).astype(np.float32)), g.init_cache(2, 16))
        before = tree_map(lambda t: t.clone(), cache)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
        pos = torch.tensor([3, 9])
        x = tm.embed_decode(stem, tok, pos, None)
        y, out = g.decode(p, x, cache, pos, tm.decode_extras(stem, x), TCTX)
        assert out is cache
        axes = driver.cache_batch_axes(g, 16)

        for r in range(2):
            xr = x[r:r + 1]
            yr, cr = g.decode(p, xr, _pick(before, axes, r), int(pos[r]),
                              tm.decode_extras(stem, xr), TCTX)
            _close(y[r:r + 1], yr)
            for (_, a), (_, b) in zip(
                    flatten_with_paths(_pick(out, axes, r)),
                    flatten_with_paths(cr)):
                _close(a, b)


def _pick(tree, axes, r):
    """Row ``r`` of a batched cache tree, each leaf sliced (kept) at its
    batch axis."""
    if isinstance(tree, dict):
        return {k: _pick(v, axes[k], r) for k, v in tree.items()}
    return tree.narrow(axes, r, 1)


def _engine_grads(eng, batch) -> dict:
    """Run one step's FWD and BWD phases and read every gradient: the
    stem's (after ``backward_embed``) and each layer's, which overwrote
    its param payload."""
    captured = {}
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
    eng.backward_embed(st)
    for path, gv in zip(eng._stem_paths, st.stem_grad):
        captured[("stem",) + path] = gv.clone()
    for g in eng.model.groups():
        for i in range(g.length):
            for path, name in zip(eng._layer_paths[g.name],
                                  eng._group_tensor_names[g.name][i]):
                captured[("groups", g.name, i) + path] = \
                    eng.params_mgr.tensor_view(name).clone()
    return captured


def _stack_layers(grads: dict) -> dict:
    """{(groups, g, i, *path): grad} -> {(groups, g, *path): [L, ...]}."""
    out, stem = {}, {}
    for key, v in grads.items():
        if key[0] == "stem":
            stem[key] = v
        else:
            out.setdefault(key[:2] + key[3:], []).append((key[2], v))
    stacked = {k: torch.stack([v for _, v in sorted(vs, key=lambda x: x[0])])
               for k, vs in out.items()}
    return {**stem, **stacked}


def test_eager_trainer_gradients_match_jax_grad(smoke):
    """Step 1 of the port's eager trainer (OPT, prefetch, the act stream,
    a budget that pages): every leaf's gradient equals ``jax.grad`` of the
    reference model's whole loss — the shared block's, which reaches the
    stem only through the extras of both units, and the embedding's, with
    x0's share.  The reference's eager engine drops the extras' gradient:
    its shared block gets zeros."""
    cfg, jcfg = smoke["cfg"], smoke["jcfg"]
    kw = dict(device_memory_bytes=4_000_000, policy="opt", lr=1e-3)
    eng = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                            init_params=params_from_jax(smoke["jp"]), **kw)
    got = _stack_layers(_engine_grads(eng, smoke["batch"]))
    assert set(got) == set(smoke["grads"])
    for path, want in smoke["grads"].items():
        _close(got[path], want, GRAD_TOL)
    shared = [k for k in got if k[:2] == ("stem", "shared_attn")]
    assert shared and all(float(got[k].abs().max()) > 0 for k in shared)

    # the reference's engine runs op by op: one unit (2 layers, no tail)
    # and one short row show its fault
    jcfg = jcfg.replace(num_layers=2)
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    jp = numpy_params(jm, 0)
    ids = smoke["batch"]["tokens"][:1, :16]
    batch = {"tokens": ids, "labels": np.roll(ids, -1, 1),
             "global_tokens": np.float32(ids.size)}

    def jloss(params):
        x, extras = jm.embed(params["stem"], {"tokens": jnp.asarray(ids)})
        for i in range(jcfg.num_units):
            x, _ = jm.groups()[0].apply(jax.tree_util.tree_map(
                lambda t, _i=i: t[_i], params["groups"]["units"]), x,
                extras, JCTX)
        return jm.head_loss(params["stem"], x, {
            k: jnp.asarray(v) for k, v in batch.items()})

    want = _jflat(jax.jit(jax.grad(jloss))(_jtree(jp)))
    ref = RefEngine(_jitted(jax_model_class(jcfg)), jcfg, init_params=jp,
                    **kw)
    st = ref.begin_step(batch)
    ref.forward_embed(st)
    for g in ref.model.groups():
        ref.forward_group_start(st, g.name)
        for i in range(g.length):
            ref.forward_layer(st, g, i)
    ref.begin_backward(st)
    for idx in range(len(st.saved) - 1, -1, -1):
        ref.backward_layer(st, idx)
    ref.backward_embed(st)
    ref_shared = _jflat({"stem": st.stem_grad})
    for k in shared:
        assert float(np.abs(np.asarray(ref_shared[k])).max()) == 0.0, k
        assert float(np.abs(np.asarray(want[k])).max()) > 0, k


def test_rank_parallel_plane_takes_the_same_gradients(short):
    """p = 2 (the batch split over two simulated ranks, grads
    reduce-scattered, the stem's summed): the stem gradient handed to the
    update, the shared block's included, equals the single-rank engine's,
    and the losses of 2 steps agree."""
    cfg = short["cfg"]
    batch = short["batch"]
    params = params_from_jax(short["jp"])
    seen = {}

    def capture(core, key):
        orig = core.update_stem

        def wrapped(stem_grad):
            seen.setdefault(key, [g.clone() for g in stem_grad])
            return orig(stem_grad)
        core.update_stem = wrapped

    one = PatrickStarEngine(model_class(cfg), cfg, device="cpu",
                            device_memory_bytes=4_000_000, lr=1e-3,
                            init_params=params)
    two = DistributedPatrickStarEngine(model_class(cfg), cfg, nproc=2,
                                       device="cpu",
                                       device_memory_bytes=4_000_000,
                                       lr=1e-3, init_params=params)
    capture(one, "one")
    capture(two.ranks[0], "two")
    losses = [(one.step(batch).loss, two.step(batch).loss)
              for _ in range(2)]
    for a, b in losses:
        assert abs(a - b) <= TOL * abs(a), losses
    for path, a, b in zip(one._stem_paths, seen["one"], seen["two"]):
        _close(b, a, GRAD_TOL)
        if path[0] == "shared_attn":
            assert float(b.abs().max()) > 0, path


# ---------------------------------------------------------------- serving
COUNTERS = ("admitted", "completed", "active", "queued", "prefill_tokens",
            "decode_tokens", "h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
            "critical_h2d_bytes", "prefetch_hits", "demand_misses",
            "peak_device_bytes")
NEW_TOKENS = [3, 2]
BUDGET = dict(device_memory_bytes=1_500_000, host_memory_bytes=24_000_000,
              max_seq_len=16)


def _serve(eng, prompts):
    rids = [eng.submit(p, n) for p, n in zip(prompts, NEW_TOKENS)]
    rows = []
    while (m := eng.step_round()) is not None:
        assert m.peak_device_bytes <= eng.device_capacity
        rows.append({f: getattr(m, f) for f in COUNTERS})
    eng.check_invariants()
    return [eng.result(r) for r in rids], rows


@pytest.fixture(scope="module")
def prompts(short):
    rng = np.random.default_rng(2)
    return [rng.integers(0, short["cfg"].vocab_size, size=n).astype(
        np.int32) for n in (9, 9)]


def test_eager_serving_matches_the_reference(short, prompts):
    """One sequence a call (the unit cache's mamba leaves do not lead
    with the batch dim, and extras are not None), the shared block's k/v
    in fp32 compute beside the fp32 SSM state in one kv chunk: greedy
    tokens and every per-round counter equal the reference engine's."""
    jcfg, cfg = short["jcfg"], short["cfg"]
    ref = RefServing(_jitted(jax_model_class(jcfg)), jcfg,
                     init_params=short["jp"], **BUDGET)
    port = ServingEngine(model_class(cfg), cfg, device="cpu",
                         init_params=params_from_jax(short["jp"]), **BUDGET)
    assert port._batchable == {"units": False, "tail": True}
    assert not port._prefill_batchable()
    want, want_rows = _serve(ref, prompts)
    got, rows = _serve(port, prompts)
    assert got == want
    assert rows == want_rows
    assert port.pool.stats.d2h_bytes > 0  # the budget paged


def test_paged_kv_raises_for_the_ssm_state(short):
    jcfg, cfg = short["jcfg"], short["cfg"]
    kw = dict(BUDGET, page_tokens=8)
    with pytest.raises(ValueError, match="clean position axis"):
        RefServing(jax_model_class(jcfg), jcfg, init_params=short["jp"],
                   **kw)
    with pytest.raises(ValueError, match="clean position axis"):
        ServingEngine(model_class(cfg), cfg, device="cpu",
                      init_params=params_from_jax(short["jp"]), **kw)


def test_compiled_round_matches_the_eager_engine(short, prompts):
    """Slot caches put the slots where each leaf's batch axis is (the
    unit's mamba states [tp, L, 2, S_slots, ...]): tokens equal the eager
    engine's, and with prefill cohorts of one the counters equal its run
    one sequence a decode call."""
    cfg = short["cfg"]
    params = params_from_jax(short["jp"])
    eager = ServingEngine(model_class(cfg), cfg, device="cpu",
                          init_params=params, max_decode_batch=1,
                          max_prefill_batch=1, **BUDGET)
    want, want_rows = _serve(eager, prompts)
    comp = CompiledServingEngine(model_class(cfg), cfg, device="cpu",
                                 init_params=params, max_prefill_batch=1,
                                 **BUDGET)
    assert comp._slot_axis["units"][("mamba", "state")] == 3
    assert comp._slot_axis["units"][("attn", "k")] == 2
    got, rows = _serve(comp, prompts)
    assert got == want
    assert rows == want_rows
    assert comp.decode_compile_count == 1 and comp.padded_slots == 2
    # batched cohorts: the same tokens
    comp = CompiledServingEngine(model_class(cfg), cfg, device="cpu",
                                 init_params=params, **BUDGET)
    got, _ = _serve(comp, prompts)
    assert got == want


def test_runtime_matches_the_reference_runtime(short):
    """The chunked-ZeRO runtime on a (dp=2, tp=1) mesh, 3 steps of
    4 x 32 from the reference's own state: losses within 1e-5 relative of
    the JAX runtime's and falling, then a decode step whose greedy tokens
    equal the reference's."""
    jcfg, cfg = short["jcfg"], short["cfg"]
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(2, 1),
                     JaxOptions())
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(2, 1, device="cpu"), RuntimeOptions())
    jps, jos = jax_driver.init_state(jrt, jax.random.key(0))
    ps, os_ = driver.place_state(rt, *stores_from_jax(jax.device_get(jps),
                                                      jax.device_get(jos)))
    jstep, _, _ = jax_driver.build_train_step(
        jrt, JaxShape("smoke", 32, 4, "train"))
    step, _, _ = driver.build_train_step(rt, InputShape("smoke", 32, 4,
                                                        "train"))
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32))
    batch = {"tokens": ids, "labels": np.roll(ids, -1, 1),
             "global_tokens": np.float32(ids.size)}
    losses = []
    for i in range(3):
        jps, jos, jm = jstep(jps, jos, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                             jnp.int32(i))
        ps, os_, m = step(ps, os_, batch, i)
        ref, got = float(jm["loss"]), float(m["loss"])
        assert np.isfinite(got) and abs(got - ref) <= TOL * abs(ref), \
            (i, ref, got)
        losses.append(got)
    assert losses[-1] < losses[0], losses
    dshape = InputShape("serve", 32, 4, "decode")
    dec, _ = driver.build_decode_step(rt, dshape)
    tok = np.zeros((4, 1), np.int32)
    nxt, _ = dec(ps, driver.init_caches(rt, dshape), tok, 5)
    jshape = JaxShape("serve", 32, 4, "decode")
    jdec, _ = jax_driver.build_decode_step(jrt, jshape)
    jnxt, _ = jdec(jps, jax_driver.init_caches(jrt, jshape),
                   jnp.asarray(tok), jnp.int32(5))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
