"""The port's MoE layer (``repro_torch.models.moe``) against its
``repro.models.moe`` twin on the same numpy inputs and weights (fp32
tolerance 1e-5: the same math summed in another order), the twin of
``tests/test_moe.py``:

* ``dispatch_indices`` equal to the reference's, over E in {2, 4, 8} and
  k in {1, 2} (seeded cases, and under hypothesis where it is installed);
* ``route_topk`` (probs, expert ids, aux loss) and ``moe_fwd``, with and
  without capacity drops, top-1, and shared experts; ties in the router
  break toward the lower expert id, as ``jax.lax.top_k``'s do;
* the capacity-drop and aux-imbalance cases of the reference's tests;
* grouped routing: with ``moe_per_row`` each batch row equals a reference
  call on that row alone, including a batch whose rows would couple if
  pooled (pooled routing drops a token that per-row routing keeps);
* a whole MoE model with a leading dense layer and shared experts
  (``first_dense_layers = 1``): layer by layer, and the loss.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from _torch_parity import numpy_params  # noqa: E402
from repro_torch.configs import model_class  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

TOL = 1e-5
JCTX = JL.AxisCtx()
TCTX = TL.AxisCtx()
ROWS = TL.AxisCtx(moe_per_row=True)


def _cfgs(**kw):
    base = dict(name="t", d_model=8, n_heads=2, n_kv_heads=2, head_dim=4,
                d_ff=16, d_ff_expert=16, vocab_size=32, n_experts=4,
                top_k=2, capacity_factor=1.25, router_aux_coef=0.01)
    base.update(kw)
    return JaxMoEConfig(**base), MoEConfig(**base)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(jcfg, seed=0):
    p = JMOE.init_moe_mlp(jax.random.key(seed), jcfg, 1, jnp.float32)
    p = jax.tree_util.tree_map(np.asarray, p)
    return p, params_from_jax(p)


def _check_dispatch(seed, e, k, t=16, cap=6):
    idx = np.random.default_rng(seed).integers(0, e, (t, k))
    want = JMOE.dispatch_indices(jnp.asarray(idx), e, cap)
    got = TMOE.dispatch_indices(torch.from_numpy(idx), e, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("e", [2, 4, 8])
def test_dispatch_indices_match_the_reference(e, k, seed):
    _check_dispatch(seed, e, k)


try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # not installed here: the seeded cases above stand
    given = None

if given is not None:
    @given(st.integers(0, 2**31 - 1), st.sampled_from([2, 4, 8]),
           st.sampled_from([1, 2]), st.integers(1, 24), st.integers(1, 8))
    @settings(max_examples=30, deadline=None)
    def test_dispatch_indices_match_the_reference_hypothesis(seed, e, k, t,
                                                             cap):
        _check_dispatch(seed, e, k, t, cap)


def test_grouped_dispatch_equals_one_call_per_group():
    idx = np.random.default_rng(3).integers(0, 4, (3, 10, 2))
    got = TMOE.dispatch_indices(torch.from_numpy(idx), 4, 5)
    for g in range(3):
        want = JMOE.dispatch_indices(jnp.asarray(idx[g]), 4, 5)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[g].numpy(), np.asarray(b))


CASES = {
    "no_drops": dict(capacity_factor=8.0),
    "drops": dict(capacity_factor=0.5),
    "top1": dict(top_k=1, n_experts=2),
    "shared": dict(n_shared_experts=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_topk_and_moe_fwd_match_the_reference(case):
    jcfg, cfg = _cfgs(**CASES[case])
    jp, tp = _params(jcfg)
    x = _rand(1, 2, 12, cfg.d_model)
    xt = x.reshape(-1, cfg.d_model)
    jr = jax.jit(JMOE.route_topk, static_argnums=2)(
        jnp.asarray(xt), jnp.asarray(jp["router"]), jcfg)
    tr = TMOE.route_topk(torch.from_numpy(xt), tp["router"], cfg)
    _close(tr[0], jr[0])
    np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))
    _close(tr[2], jr[2])
    jy, jaux = jax.jit(JMOE.moe_fwd, static_argnums=(2, 3))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jcfg, JCTX)
    ty, taux = TMOE.moe_fwd(tp, torch.from_numpy(x), cfg, TCTX)
    _close(ty, jy)
    _close(taux, jaux)
    if case == "drops":  # some (token, k) assignment was dropped
        cap = max(int(24 * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts), 4)
        _, keep, _ = TMOE.dispatch_indices(tr[1], cfg.n_experts, cap)
        assert not keep.all()


def test_route_topk_breaks_ties_toward_the_lower_index():
    jcfg, cfg = _cfgs(n_experts=8, top_k=2)
    x = _rand(2, 6, cfg.d_model)
    w = np.zeros((cfg.d_model, 8), np.float32)  # every prob equal
    w[:, 5] = w[:, 6] = 1.0  # two tied leaders
    for xs in (x, np.abs(x)):
        tr = TMOE.route_topk(torch.from_numpy(xs), torch.from_numpy(w), cfg)
        jr = JMOE.route_topk(jnp.asarray(xs), jnp.asarray(w), jcfg)
        np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))
    zero = TMOE.route_topk(torch.from_numpy(x), torch.zeros(cfg.d_model, 8),
                           cfg)[1]
    assert (zero.numpy() == [0, 1]).all()


def test_capacity_drops_tokens():
    jcfg, cfg = _cfgs(n_experts=2, top_k=1, capacity_factor=0.5,
                      router_aux_coef=0.0)
    _, tp = _params(jcfg)
    x = torch.from_numpy(_rand(4, 1, 16, cfg.d_model))
    y, _ = TMOE.moe_fwd(tp, x, cfg, TCTX)
    norms = np.linalg.norm(y.reshape(-1, cfg.d_model).numpy(), axis=-1)
    assert (norms < 1e-6).any()


def test_aux_loss_penalizes_imbalance():
    jcfg, cfg = _cfgs(n_experts=4, top_k=1, router_aux_coef=1.0)
    x = _rand(5, 64, cfg.d_model)
    w_bal = np.zeros((cfg.d_model, 4), np.float32)
    w_col = w_bal.copy()
    w_col[:, 0] = 10.0
    auxes = []
    for w in (w_bal, w_col):
        _, _, ta = TMOE.route_topk(torch.from_numpy(x), torch.from_numpy(w),
                                   cfg)
        _, _, ja = JMOE.route_topk(jnp.asarray(x), jnp.asarray(w), jcfg)
        _close(ta, ja)
        auxes.append(float(ta))
    assert auxes[1] > auxes[0]


def test_grouped_routing_equals_one_reference_call_per_row():
    """Rows whose tokens all prefer expert 0: pooled, the batch's capacity
    max(int(rows * s * k * cf / E), 4) is shared by every row's
    assignments; per row, each row has its own."""
    jcfg, cfg = _cfgs(capacity_factor=1.0)
    jp, tp = _params(jcfg)
    tp["router"] = torch.zeros_like(tp["router"])
    tp["router"][:, 0] = 1.0  # every token's top-1 is expert 0
    jp = dict(jp, router=tp["router"].numpy())
    x = np.abs(_rand(6, 3, 8, cfg.d_model)) + 0.5
    ty, _ = TMOE.moe_fwd(tp, torch.from_numpy(x), cfg, ROWS)
    jfwd = jax.jit(JMOE.moe_fwd, static_argnums=(2, 3))
    jtree = jax.tree_util.tree_map(jnp.asarray, jp)
    for r in range(x.shape[0]):
        jy, _ = jfwd(jtree, jnp.asarray(x[r:r + 1]), jcfg, JCTX)
        _close(ty[r:r + 1], jy)
    # pooled, the rows couple: the batch's expert 0 runs out of slots, and
    # a token a row keeps on its own comes back empty
    pooled, _ = TMOE.moe_fwd(tp, torch.from_numpy(x), cfg, TCTX)
    jpooled, _ = jfwd(jtree, jnp.asarray(x), jcfg, JCTX)
    _close(pooled, jpooled)
    assert not np.allclose(pooled.numpy(), ty.numpy(), atol=1e-3)


def test_moe_layer_grads_flow_through_the_gathers():
    jcfg, cfg = _cfgs(capacity_factor=0.75)
    jp, tp = _params(jcfg)
    x = _rand(7, 2, 12, cfg.d_model)
    tree = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = TMOE.moe_fwd(tree, tx, cfg, TCTX)
    (ty.square().sum() + taux).backward()

    def loss(p, xx):
        y, aux = JMOE.moe_fwd(p, xx, jcfg, JCTX)
        return jnp.sum(y * y) + aux
    jg = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    _close(tx.grad, jg[1], 1e-4)
    for key in tree:
        _close(tree[key].grad, jg[0][key], 1e-4)


def _model_pair():
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    kw = dict(param_dtype="float32", compute_dtype="float32",
              first_dense_layers=1, n_shared_experts=1, num_layers=3)
    jcfg = jax_config("mixtral-8x7b", smoke=True).replace(**kw)
    cfg = get_config("mixtral-8x7b", smoke=True).replace(**kw)
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    tm = model_class(cfg)(cfg, TCTX)
    jparams = numpy_params(jm, 0)
    return jcfg, cfg, jm, tm, jparams, params_from_jax(jparams)


def _layer(tree, i, to_torch):
    if isinstance(tree, dict):
        return {k: _layer(v, i, to_torch) for k, v in tree.items()}
    return tree[i] if to_torch else jnp.asarray(tree[i])


def test_moe_model_with_a_dense_layer_and_shared_experts():
    """The two block groups of a ``first_dense_layers = 1`` config: the
    param tree's shapes and dtypes (the fp32 router among them), each
    layer's apply (x and aux) and the loss."""
    jcfg, cfg, jm, tm, jp, tp = _model_pair()
    assert [g.name for g in tm.groups()] == [g.name for g in jm.groups()] \
        == ["dense_layers", "moe_layers"]
    specs = jax.tree_util.tree_leaves_with_path(jm.param_specs())
    from repro_torch.models.api import flatten_with_paths
    got = flatten_with_paths(tm.param_specs())
    assert len(got) == len(specs)
    for (jpath, jspec), (path, t) in zip(specs, got):
        assert tuple(t.shape) == tuple(jspec.shape), path
        assert str(t.dtype).split(".")[1] == jspec.dtype.name, path
    assert flatten_with_paths(tp)[0][1].dtype == torch.float32
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 40))
    batch = {"tokens": ids, "labels": np.roll(ids, -1, 1),
             "global_tokens": np.float32(ids.size)}
    tx, _ = tm.embed(tp["stem"], {"tokens": torch.from_numpy(ids)})
    jx, _ = jm.embed(jp["stem"], {"tokens": jnp.asarray(ids)})
    for tg, jg in zip(tm.groups(), jm.groups()):
        japply = jax.jit(jg.apply, static_argnums=3)
        for i in range(tg.length):
            tx, ta = tg.apply(_layer(tp["groups"][tg.name], i, True), tx,
                              None, TCTX)
            jx, ja = japply(_layer(jp["groups"][jg.name], i, False), jx,
                            None, JCTX)
            _close(tx, jx)
            _close(torch.as_tensor(ta), ja)
    tl = tm.head_loss(tp["stem"], tx, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
    jl = jm.head_loss(jp["stem"], jx, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    _close(tl, jl)


def test_mla_config_raises():
    """An MLA config now maps to ``MoELM`` and builds MLA attention in its
    MoE layers (``repro_torch.models.mla``); what still raises is an arch
    type no config defines."""
    cfg = MoEConfig(name="mla", kv_lora_rank=64, qk_nope_dim=16,
                    qk_rope_dim=16, v_head_dim=16)
    cls = model_class(cfg)
    assert cls.__name__ == "MoELM"
    attn = cls(cfg, TCTX).param_specs()["groups"]["moe_layers"]["attn"]
    assert sorted(attn) == ["kv_norm", "w_dkv", "w_krope", "w_uk", "w_uv",
                            "wo", "wq"]
    with pytest.raises(KeyError, match="unknown arch_type"):
        model_class(cfg.replace(arch_type="nobody"))


def test_mixtral_chunk_size_holds_the_largest_expert_tensor():
    """mixtral at full width: [8, 4096, 14336] expert tensors (469.8 M
    elements) must fit one chunk.  The port's search equals the
    reference's and holds them (it packs two a chunk); 2^29 elements (2
    GiB fp32, the pinned allocator's block) holds one with the attention
    beside it: three chunks a layer."""
    from repro.configs import get_config as jax_config
    from repro.core.chunk import TensorSpec as JSpec
    from repro.core.chunk import build_chunk_map as jax_build
    from repro.core.chunk import search_chunk_size as jax_search
    from repro_torch.configs import get_config
    from repro_torch.core.chunk import TensorSpec, build_chunk_map, \
        search_chunk_size
    from repro_torch.core.serving import _leaves_with_names

    cfg = get_config("mixtral-8x7b").replace(num_layers=2)
    tm = model_class(cfg)(cfg, TCTX)
    layers = tm.param_specs()["groups"]["moe_layers"]
    names = [(f"moe_layers.{i}" + n[len("x"):], tuple(t.shape[1:]))
             for i in range(2)
             for n, t in _leaves_with_names(layers, "x")]
    largest = max(int(np.prod(s)) for _, s in names)
    assert largest == 8 * 4096 * 14336 == 469_762_048
    specs = [TensorSpec(n, s) for n, s in names]
    got = search_chunk_size(specs, align=256)
    want = jax_search([JSpec(n, s) for n, s in names], align=256)
    assert got.chunk_size == want.chunk_size >= largest
    for size, chunks in ((got.chunk_size, 3), (1 << 29, 6)):
        cmap = build_chunk_map(specs, size)
        assert cmap.num_chunks == chunks
        ref = jax_build([JSpec(n, s) for n, s in names], size)
        assert [(p.name, p.chunk_id, p.offset) for p in cmap.placements] \
            == [(p.name, p.chunk_id, p.offset) for p in ref.placements]
    jcfg = jax_config("mixtral-8x7b")
    assert jcfg.d_ff_expert * jcfg.d_model * jcfg.n_experts == largest


def test_convert_carries_the_moe_leaves_and_dtypes():
    """A bf16 reference param tree with two block groups arrives with the
    same shapes and dtypes: experts [E, d, f] and [E, f, d] in bf16, the
    router in fp32."""
    from repro.configs import get_config as jax_config

    jcfg = jax_config("mixtral-8x7b", smoke=True).replace(
        first_dense_layers=1, num_layers=3)
    jm = jax_model_class(jcfg)(jcfg, JCTX)
    jp = jax.device_get(jm.init_params(jax.random.key(0)))
    tp = params_from_jax(jp)
    flat = jax.tree_util.tree_leaves_with_path(jp)
    from repro_torch.models.api import flatten_with_paths
    got = dict(flatten_with_paths(tp))
    assert len(got) == len(flat)
    for path, leaf in flat:
        key = tuple(k.key for k in path)
        assert tuple(got[key].shape) == leaf.shape, key
        want = "float32" if leaf.dtype.name == "float32" else "bfloat16"
        assert str(got[key].dtype) == f"torch.{want}", key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(leaf, np.float32))
    moe = got[("groups", "moe_layers", "moe", "w_gate")]
    assert tuple(moe.shape) == (2, 4, 128, 256) and moe.dtype == torch.bfloat16
    assert got[("groups", "moe_layers", "moe", "router")].dtype == \
        torch.float32
    assert ("groups", "dense_layers", "mlp", "w_up") in got
