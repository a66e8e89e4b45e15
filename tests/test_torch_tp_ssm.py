"""The port's SSM layers at tp > 1 (``repro_torch.models.ssm``: Mamba2,
mLSTM, sLSTM on the simulated model axis of ``repro_torch.models.tp``)
against the reference's layers at tp = 1 on the CPU, on one global set of
weights split by the port's rule (``split_for_tp`` with the model's
``tp_axes()``: mLSTM's value channels head-major).

Each case runs the layer at zamba2-smoke's (Mamba2: 8 heads of 32) or
xlstm-smoke's (mLSTM, sLSTM: 4 heads of 64) width, fp32, over a ragged
24 positions (chunks of 16): the output, every gradient (the input's,
each replicated leaf's, each rank's shard of each sharded leaf, against
``jax.grad`` of the reference at tp = 1 split by the same rule), the
prefill cache of the first 22 positions rank by rank, and 2 decode steps
from it against the full forward's last positions, each within 1e-5 of
the largest value it is compared with.  mLSTM at tp 3 takes the
reference's replicated branch (3 does not divide the head width 64).

The local param and cache shapes are the reference's at each tp.  And
the reference's own ``shard_map`` run of its tp = 1 tree split
contiguously (its ``split_for_tp``) differs from its tp = 1 output by
more than 1e-2 of the largest output for Mamba2 and mLSTM (its gated
norm averages over each rank's channels; its mLSTM pairs each rank's
columns with other heads' values), and equals it for sLSTM, which is
replicated: the port holds the function that does not depend on tp.
Last, the reference's own tp = 2 stores of zamba2-smoke and xlstm-smoke
load into the port's runtime as they are.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.mesh import _mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.layers import shard_map_compat  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import stores_from_jax  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.models.api import flatten_with_paths, tree_map  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402

import _torch_tp as H  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = 1e-5
B, S, PRE = 2, 24, 22  # batch, positions, prefill positions (then 2 decode)
MNAMES, SNAMES = ("S", "n", "m"), ("c", "n", "h", "m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these smoke-size tensors: the suite runs
    several workers on the machine's cores, where idle pool threads only
    contend (restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ctx(tp):
    return JL.AxisCtx(model_axis="model", tp=tp, data_axis="data", dp=1)


def _jfwd(kind):
    return {"mamba2": JS.mamba2_fwd, "mlstm": JS.mlstm_fwd,
            "slstm": JS.slstm_fwd}[kind]


def _jcache(kind, aux):
    """The reference's (state, carries) of one call, with the port's
    names."""
    if kind == "mamba2":
        state, cc = aux
        return {"state": state, "conv_x": cc["x"], "conv_B": cc["B"],
                "conv_C": cc["C"]}
    return dict(zip(MNAMES if kind == "mlstm" else SNAMES, aux))


def _cache_axes(kind, cfg, tp):
    """How the caches shard: Mamba2's state by heads and its x conv tail
    by channels; mLSTM's S by value columns (contiguous in its last axis)
    where the layer shards; everything else every rank's copy."""
    if kind == "mamba2":
        return {"state": 1, "conv_x": 2, "conv_B": None, "conv_C": None}
    if kind == "mlstm":
        ax = 3 if TS._mlstm_sharded(cfg, tp) else None
        return {"S": ax, "n": None, "m": None}
    return dict.fromkeys(SNAMES)


def _port_axes(kind, cfg, tp):
    return {"mamba2": TS.mamba2_tp_axes, "slstm": TS.slstm_tp_axes,
            "mlstm": lambda: TS.mlstm_tp_axes(cfg, tp)}[kind]()


def _jax_axes(kind, jcfg, tp):
    return {"mamba2": JS.mamba2_tp_axes, "slstm": JS.slstm_tp_axes,
            "mlstm": lambda: JS.mlstm_tp_axes(jcfg, tp)}[kind]()


def _port_step(kind, p, x, cfg, ctx, cache=None):
    """(y, the cache) of the port's layer from ``cache`` (None: zeros)."""
    if kind == "mamba2":
        if cache is None:
            y, (state, cc) = TS.mamba2_fwd(p, x, cfg, ctx)
            return y, TS.mamba2_cache(state, cc, ctx.tp)
        return TS.mamba2_decode(p, x, cache, cfg, ctx)
    fwd = TS.mlstm_fwd if kind == "mlstm" else TS.slstm_fwd
    return fwd(p, x, cfg, ctx, cache)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


KINDS = ["mamba2", "mlstm", "slstm"]
CASES = [("mamba2", 2), ("mamba2", 4), ("mlstm", 2), ("mlstm", 4),
         ("mlstm", 3), ("slstm", 2), ("slstm", 4)]


@functools.lru_cache(maxsize=None)
def _layer(kind):
    """One layer's global weights (the reference's init at tp = 1, with
    Mamba2's ``A_log``, ``dt_bias`` and ``D`` in their useful range and
    every norm weight drawn away from 1, so each rank's slice of it
    shows), an input, a cotangent, and the reference's tp = 1 results:
    the output and ``jax.grad`` over 24 positions, the prefill cache of
    22 and the 2 decode steps after it (computed once a test process)."""
    arch = "zamba2-1.2b" if kind == "mamba2" else "xlstm-1.3b"
    jcfg = jax_config(arch, smoke=True).replace(**FP32)
    cfg = get_config(arch, smoke=True).replace(**FP32)
    init = {"mamba2": JS.init_mamba2, "mlstm": JS.init_mlstm,
            "slstm": JS.init_slstm}[kind]
    jp = jax.tree_util.tree_map(np.asarray, jax.jit(
        init, static_argnums=(1, 2, 3))(jax.random.key(0), jcfg, 1,
                                        jnp.float32))
    rng = np.random.default_rng(3)
    if kind == "mamba2":
        nh = jcfg.mamba_heads
        jp.update(A_log=np.log(rng.uniform(1, 16, nh)).astype(np.float32),
                  dt_bias=np.log(np.expm1(np.exp(rng.uniform(
                      np.log(1e-3), np.log(0.1), nh)))).astype(np.float32),
                  D=(1 + 0.1 * rng.standard_normal(nh)).astype(np.float32))
    jp["norm"] = (1 + 0.2 * rng.standard_normal(jp["norm"].shape)
                  ).astype(np.float32)
    x = _rand(rng, B, S, jcfg.d_model)
    cot = _rand(rng, B, S, jcfg.d_model)
    fwd, ctx1 = _jfwd(kind), JL.AxisCtx()

    def loss(p, xx):
        y = fwd(p, xx, jcfg, ctx1)[0]
        return jnp.sum(y * cot), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jp, x)
    pre = jax.jit(lambda p, xx: fwd(p, xx, jcfg, ctx1))(jp, x[:, :PRE])
    want = dict(y=np.asarray(y), gx=np.asarray(gx),
                gp={k: np.asarray(v) for k, v in gp.items()},
                cache={k: np.asarray(v) for k, v in
                       _jcache(kind, pre[1]).items()})
    return kind, jcfg, cfg, jp, x, cot, want


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, what):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _port_params(jp, axes, tp):
    """The global tree split by the port's rule: each sharded leaf a
    ``Ranks`` of the ranks' shards, each a leaf autograd tracks."""
    g = {k: _t(v) for k, v in jp.items()}
    shards = [TP.split_for_tp(g, axes, tp, r) for r in range(tp)]
    p = TP.merge_ranks(shards, axes)
    return tree_map(lambda t: t.clone().requires_grad_(), p)


@pytest.mark.parametrize("kind,tp", CASES)
def test_tp_layer_matches_the_reference_at_tp1(kind, tp):
    """Forward, every gradient, the prefill cache rank by rank and the
    decode after it at tp against the reference at tp = 1 (1e-5 of the
    largest value); Mamba2 and sLSTM at tp 2 and 4, mLSTM at 2, 4 and 3
    (its replicated branch: every leaf and cache every rank's copy, no
    psum)."""
    kind, jcfg, cfg, jp, x, cot, want = _layer(kind)
    ctx = L.AxisCtx(tp=tp)
    axes = _port_axes(kind, cfg, tp)
    if kind == "mlstm":
        assert TS._mlstm_sharded(cfg, tp) == (tp != 3)
    p = _port_params(jp, axes, tp)
    tx = _t(x).requires_grad_()
    y, _ = _port_step(kind, p, tx, cfg, ctx)
    _close(y, want["y"], "y")
    leaves = flatten_with_paths(p)
    flat = [t for _, v in leaves for t in
            (v if isinstance(v, TP.Ranks) else [v])]
    grads = torch.autograd.grad((y * _t(cot)).sum(), [tx] + flat)
    _close(grads[0], want["gx"], "gx")
    i = 1
    gp = {k: _t(v) for k, v in want["gp"].items()}
    for (path, v), ax in zip(leaves, [a for _, a in
                                      flatten_with_paths(axes)]):
        name = path[0]
        if ax is None:
            assert not isinstance(v, TP.Ranks), name
            _close(grads[i], gp[name], name)
            i += 1
            continue
        for r in range(tp):
            _close(grads[i], TP.split_for_tp({name: gp[name]}, {name: ax},
                                             tp, r)[name], (name, r))
            i += 1
    assert i == len(grads)
    # prefill then decode, under no_grad as the runtime serves
    with torch.no_grad():
        _, cache = _port_step(kind, p, tx[:, :PRE], cfg, ctx)
        cax = _cache_axes(kind, cfg, tp)
        for name, ax in cax.items():
            got = cache[name]
            assert isinstance(got, TP.Ranks) and len(got) == tp, name
            for r in range(tp):
                ref = want["cache"][name]
                if ax is not None:
                    ref = TP.split_for_tp({name: _t(ref)}, {name: ax}, tp,
                                          r)[name]
                _close(got[r], ref, (name, "cache", r))
        for pos in range(PRE, S):
            yd, cache = _port_step(kind, p, tx[:, pos:pos + 1], cfg, ctx,
                                   cache)
            _close(yd[:, 0], want["y"][:, pos], ("decode", pos))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_shapes_are_the_reference_shapes(kind, tp):
    """Every param leaf's tp-local shape (the port's init and the split
    of the global tree) and every cache leaf's are the reference's at
    tp; the axes are the reference's integers."""
    kind, jcfg, cfg, jp, x, _, _ = _layer(kind)
    axes = _port_axes(kind, cfg, tp)
    assert axes == _jax_axes(kind, jcfg, tp)
    jinit = {"mamba2": JS.init_mamba2, "mlstm": JS.init_mlstm,
             "slstm": JS.init_slstm}[kind]
    tinit = {"mamba2": TS.init_mamba2, "mlstm": TS.init_mlstm,
             "slstm": TS.init_slstm}[kind]
    jloc = jax.eval_shape(lambda k: jinit(k, jcfg, tp, jnp.float32),
                          jax.random.key(0))
    with torch.device("meta"):
        tloc = tinit(torch.Generator(), cfg, tp)
    split = TP.split_for_tp({k: _t(v) for k, v in jp.items()}, axes, tp, 1)
    for k, v in jloc.items():
        assert tuple(tloc[k].shape) == tuple(v.shape) == tuple(
            split[k].shape), k
    if kind == "mamba2":
        tc = TS.mamba2_init_cache(cfg, B, tp, torch.float32)
        jc = JS.mamba2_init_cache(jcfg, B, tp, jnp.float32)
    elif kind == "mlstm":
        tc = TS.mlstm_init_cache(cfg, B, tp)
        jc = dict(zip(MNAMES, JS.mlstm_init_cache(jcfg, B, tp)))
    else:
        dh = cfg.d_inner // cfg.n_heads
        tc = TS.slstm_init_state(B, cfg.n_heads, dh)
        jc = dict(zip(SNAMES, JS.slstm_init_state(B, cfg.n_heads, dh)))
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    with torch.no_grad():
        _, cache = _port_step(kind, _port_params(jp, axes, tp),
                              _t(x[:, :PRE]), cfg, L.AxisCtx(tp=tp))
    for k, v in cache.items():
        assert all(tuple(t.shape) == tuple(tc[k].shape) for t in v), k


@pytest.mark.parametrize("kind", KINDS)
def test_reference_tp2_differs_from_its_tp1(kind):
    """The reference's ``shard_map`` run at tp 2 of its tp = 1 tree, split
    contiguously as its ``split_for_tp`` does, against its own tp = 1
    output: Mamba2 and mLSTM differ by more than 1e-2 of the largest
    output (the local gated norm; mLSTM's columns paired with other
    heads' values), sLSTM (replicated) agrees within 1e-5 — while the
    port at tp 2 agrees with tp = 1 (the test above)."""
    kind, jcfg, cfg, jp, x, _, want = _layer(kind)
    tp = 2
    jaxes = _jax_axes(kind, jcfg, tp)
    specs = {k: P() if a is None else P(*([None] * a + ["model"]))
             for k, a in jaxes.items()}
    fwd = _jfwd(kind)
    f = jax.jit(shard_map_compat(
        lambda p, xx: fwd(p, xx, jcfg, _ctx(tp))[0],
        mesh=_mesh((1, tp), ("data", "model")), in_specs=(specs, P()),
        out_specs=P(), check_vma=False))
    got = np.asarray(f(jp, jnp.asarray(x)), dtype=np.float64)
    ref = want["y"].astype(np.float64)
    gap = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
    if kind == "slstm":
        assert gap <= TOL, gap
    else:
        assert gap > 1e-2, gap


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b"])
def test_reference_tp2_stores_convert_as_they_are(arch):
    """The reference's own tp = 2 stores (its ``init_state`` draws each
    rank's shard) have the port's local layout: ``stores_from_jax`` takes
    them leaf for leaf, every replicated leaf's copies are bitwise equal
    across the ranks, and the port's runtime steps from them to a finite
    loss."""
    jrt, rt = H.runtimes(arch, 1, 2, cfg_kw=dict(
        num_layers=3 if arch == "zamba2-1.2b" else 2))
    (ps, oss), (tps, tos) = H.start(jrt, rt)
    ref = H.store_parts(*stores_from_jax(jax.device_get(ps),
                                         jax.device_get(oss)))
    got = H.store_parts(tps, tos)
    for key, r in ref.items():
        assert torch.equal(got[key], r), key
    assert all(tps[name].shape[0] == 2 for name in rt.layouts)
    assert H.replicated_equal(rt, tps, tos) > 0
    step, _, _ = driver.build_train_step(rt, InputShape("t", H.S, H.B,
                                                        "train"))
    _, _, m = step(tps, tos, H.batches(rt.cfg, 1)[0], 0)
    assert np.isfinite(float(m["loss"]))
