"""The port's chunked runtime at tp = 2 against the reference's
``shard_map`` runs on the CPU: the twin of ``tests/test_tp_parity.py``
(the loss and every gradient leaf, against the reference's runtime and
the tp=1 oracle).  The port differentiates the loss once, so its
gradients are the oracle's; the reference's runtime differentiates each
model rank's copy of the replicated loss, which its test divides by tp
(``tests/_torch_tp.py``).  The other tp runtime files:
``test_torch_tp_steps.py`` (steps, dp x tp, pods, the conversion),
``test_torch_tp_moe.py`` (the "ep" MoE and MLA, ``moe_combine_first``,
the CLI), ``test_torch_tp_serve.py`` (serving)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core import zero as jzero  # noqa: E402
from repro.models.layers import AxisCtx as JaxCtx  # noqa: E402
from repro.models.layers import shard_map_compat  # noqa: E402
from repro_torch.convert import stores_from_jax  # noqa: E402
from repro_torch.core import zero  # noqa: E402
from repro_torch.core.engine import to_device_batch  # noqa: E402
from repro_torch.models.api import flatten_with_paths  # noqa: E402

import _torch_tp as H  # noqa: E402

B, S = H.B, H.S


def _split(tree, axes, rank, tp, shift=0):
    def split(p, ax):
        if ax is None:
            return p
        n = p.shape[ax + shift] // tp
        return jax.lax.slice_in_dim(p, rank * n, (rank + 1) * n,
                                    axis=ax + shift)
    return jax.tree.map(split, tree, axes, is_leaf=lambda x: x is None)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b"])
def test_tp2_loss_and_grads_match_reference_and_oracle(arch):
    """The twin of ``tests/test_tp_parity.py`` at tp = 2: the port's loss
    and every gradient leaf against the reference's runtime under its
    ``shard_map`` (the loss psummed over the model axis and divided by
    tp, as that test does) and against the tp=1 oracle (the bare model,
    ``jax.grad``); the loss within 5e-5, each leaf within 2e-4 of its
    largest gradient: sharded leaves rank by rank, replicated leaves on
    every rank."""
    tp = 2
    jcfg, cfg = H.configs(arch)
    tok = np.asarray(jax.random.randint(jax.random.key(1), (B, S), 0,
                                        cfg.vocab_size))
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1),
             "global_tokens": np.float32(B * S)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ctx1 = JaxCtx()
    model1 = jax_model_class(jcfg)(jcfg, ctx1)
    params1 = model1.init_params(jax.random.key(7))

    def loss1(params):
        x, extras = model1.embed(params["stem"], jbatch)
        aux = jnp.float32(0.0)
        for g in model1.groups():
            x, extras = model1.between_groups(g.name, x, extras,
                                              params["stem"], jbatch)

            def body(c, lp, _g=g):
                cx, ca = c
                y, a = _g.apply(lp, cx, extras, ctx1)
                return (y, ca + jnp.float32(a)), None
            (x, aux), _ = jax.lax.scan(body, (x, aux),
                                       params["groups"][g.name])
        return model1.head_loss(params["stem"], x, jbatch) + aux

    l1, g1 = jax.jit(jax.value_and_grad(loss1))(params1)
    jrt, rt = H.runtimes(arch, 1, tp)
    axes = jrt.tp_axes

    def build(rank):
        stem_l = _split(params1["stem"], axes["stem"], rank, tp)
        st = {"stem": jzero.flatten_to_store(jrt.layouts["stem"],
                                             stem_l)[None]}
        for g in jrt.model.groups():
            loc = _split(params1["groups"][g.name], axes["groups"][g.name],
                         rank, tp, shift=1)
            st[g.name] = jax.vmap(lambda t, _l=jrt.layouts[g.name]:
                                  jzero.flatten_to_store(_l, t))(loc)[None]
        return st

    pstores = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0),
                           *[build(r) for r in range(tp)])

    def loss2(ps, b):
        from repro.models.layers import vary_to
        tot = jrt._loss_local(ps, b)[0]
        return jax.lax.psum(vary_to(tot, ("data", "model")),
                            ("data", "model")) / tp

    f = jax.jit(shard_map_compat(
        jax.value_and_grad(loss2), mesh=jrt.mesh,
        in_specs=(jrt.store_pspecs(), {k: P() for k in jbatch}),
        out_specs=(P(), jrt.store_pspecs()), check_vma=True))
    l2, g2 = f(pstores, jbatch)
    tps = stores_from_jax(jax.device_get(pstores), {})[0]
    loss, aux, grads = rt.grads(tps, to_device_batch(batch, "cpu"))
    got = float(loss + aux)
    for want in (float(l1), float(l2)):
        assert abs(got - want) < 5e-5 * max(1.0, abs(want)), (got, want)
    g2 = stores_from_jax(jax.device_get(g2), {})[0]
    for g in rt.model.groups():
        lay = rt.layouts[g.name]
        ga = [a for _, a in flatten_with_paths(rt.tp_axes["groups"][g.name])]
        ref = jax.tree_util.tree_flatten_with_path(
            jax.device_get(g1["groups"][g.name]))[0]
        for layer in range(g.length):
            ranks = [flatten_with_paths(zero.unflatten_from_flat(
                lay, grads[g.name][layer][r].reshape(-1))) for r in range(tp)]
            refs = [flatten_with_paths(zero.unflatten_from_flat(
                lay, g2[g.name][r, layer].reshape(-1))) for r in range(tp)]
            for i, ((path, a1), ax) in enumerate(zip(ref, ga)):
                want = torch.from_numpy(np.array(a1[layer]))
                scale = float(want.abs().max()) + 1e-9
                parts = [rk[i][1] for rk in ranks]
                if ax is None:
                    err = max(float((p - want).abs().max()) for p in parts)
                else:
                    err = float((torch.cat(parts, ax) - want).abs().max())
                assert err / scale < 2e-4, (g.name, path, err / scale)
                for p, rr in zip(parts, refs):
                    e2 = float((p - rr[i][1]).abs().max())
                    assert e2 / scale < 2e-4, (g.name, path, "ref", e2)
