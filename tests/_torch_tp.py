"""Shared helpers of the tensor-parallel runtime tests
(``tests/test_torch_tp_*.py``).

Both runtimes start from one state: the reference's stores (its
``init_state``), brought over by ``stores_from_jax`` as they are,
``[tp, ...]`` leading.

**The gradient's scale.**  The port differentiates the loss once: its
gradients are the tp=1 oracle's.  The reference's train step
differentiates each model rank's copy of the replicated loss, and psums
the gradients over ``pod`` that the transpose of its pod-replicated
stores has already summed, so its step's gradients are ``tp x pods``
times the oracle's; its own ``tests/test_tp_parity.py`` divides the loss
by tp for that reason.  ADAM is scale-free but for ``eps``, so the scaled
step differs where a gradient is within a few orders of ``eps``.  Where
the tests run the reference's step, its local loss's cotangent carries
``1 / (tp x pods)`` (:func:`oracle_scale`), as its test's does; its
reported loss is untouched.  Store tolerances are the single-device
runtime test's: every element within 1e-5 but for at most 1e-4 of a
part, all within ADAM's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.configs import model_class as jax_model_class
from repro.configs.base import InputShape as JaxShape
from repro.launch.mesh import make_smoke_mesh as jax_mesh
from repro.runtime import driver as jax_driver
from repro.runtime.step import ChunkedRuntime as JaxRuntime
from repro.runtime.step import RuntimeOptions as JaxOptions
from repro_torch.configs import get_config, model_class
from repro_torch.configs.base import InputShape
from repro_torch.convert import stores_from_jax
from repro_torch.core import zero
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import tp as TP
from repro_torch.models.api import flatten_with_paths
from repro_torch.runtime import driver
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions

FP32 = dict(param_dtype="float32", compute_dtype="float32")
B, S = 4, 32


def configs(arch, **kw):
    kw = dict(FP32, **kw)
    return (jax_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def oracle_scale(jrt, n: int):
    """The reference's local loss with its cotangent carrying ``1/n``
    (module docstring): its step then applies the oracle's gradients."""
    local = jrt._loss_local

    def scaled(pstores, batch):
        tot, rest = local(pstores, batch)
        return tot / n, rest

    jrt._loss_local = scaled
    return jrt


def runtimes(arch, dp, tp, pods=1, cfg_kw=None, **opt):
    """(the reference's runtime, the port's) on one mesh, their layouts
    checked equal."""
    jcfg, cfg = configs(arch, **(cfg_kw or {}))
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(dp, tp, pods),
                     JaxOptions(**opt))
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(dp, tp, pods, device="cpu"),
                        RuntimeOptions(**opt))
    for name, lay in rt.layouts.items():
        assert lay.store_shape == jrt.layouts[name].store_shape, name
    return jrt, rt


def start(jrt, rt):
    """One state for both: the reference's ``init_state``, converted."""
    ps, oss = jax_driver.init_state(jrt, jax.random.key(0))
    tps, tos = stores_from_jax(jax.device_get(ps), jax.device_get(oss))
    return (ps, oss), driver.place_state(rt, tps, tos)


def batches(cfg, n, b=B, s=S):
    nxt = make_batch_fn(cfg, b, s, seed=3)
    out = []
    for _ in range(n):
        bb = nxt()
        bb.pop("mask")
        out.append(bb)
    return out


def store_parts(pstores, osstores) -> dict:
    out = {f"param/{k}": v for k, v in pstores.items()}
    for name, streams in osstores.items():
        for k, parts in streams.items():
            for part, t in parts.items():
                out[f"{name}/{k}/{part}"] = t
    return out


def check_stores(ref, got, steps, lr=1e-3, tol=1e-5):
    """Every element within ``tol`` but at most 1e-4 of a part, all
    within ADAM's bound (2 lr a step)."""
    ref, got = store_parts(*ref), store_parts(*got)
    assert ref.keys() == got.keys()
    for key, r in ref.items():
        g = got[key]
        assert g.shape == r.shape and g.dtype == r.dtype, key
        if not r.numel():
            continue
        err = (r.double() - g.double()).abs()
        far = int((err > tol).sum())
        assert far <= 1e-4 * r.numel(), (key, far, float(err.max()))
        assert float(err.max()) <= 2 * steps * lr, (key, float(err.max()))


def replicated_equal(rt, pstores, osstores) -> int:
    """Every rank's copy of every replicated leaf, in the param stores and
    each optimizer-state stream, bitwise equal to rank 0's; returns the
    elements compared."""
    stores = {"param": pstores}
    for k in ("p32", "m", "v"):
        stores[k] = {name: zero.merge_groups(streams[k]["dev"],
                                             streams[k]["host"])
                     for name, streams in osstores.items()}
    n = 0
    for label, st in stores.items():
        for name, lay in rt.layouts.items():
            axes = (rt.tp_axes["stem"] if name == "stem"
                    else rt.tp_axes["groups"][name])
            t = st[name]
            flat = (t.reshape(rt.ctx.tp, -1) if name == "stem"
                    else t.reshape(rt.ctx.tp, t.shape[1], -1))
            for off, cnt in TP.replicated_ranges(lay, axes):
                seg = flat[..., off:off + cnt]
                for r in range(1, rt.ctx.tp):
                    assert torch.equal(seg[r], seg[0]), (label, name, off)
                n += cnt
    return n


def run_both(jrt, rt, steps_batches, shape=None):
    """Both runtimes' train steps over ``steps_batches`` from one start:
    ([(ref loss, loss, ref aux, aux)], the reference's stores converted,
    the port's)."""
    (ps, oss), (tps, tos) = start(jrt, rt)
    shape = shape or (S, B)
    jstep, _, _ = jax_driver.build_train_step(
        jrt, JaxShape("t", shape[0], shape[1], "train"))
    step, _, _ = driver.build_train_step(
        rt, InputShape("t", shape[0], shape[1], "train"))
    losses = []
    for i, batch in enumerate(steps_batches):
        ps, oss, jm = jstep(ps, oss, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                            jnp.int32(i))
        tps, tos, m = step(tps, tos, batch, i)
        losses.append((float(jm["loss"]), float(m["loss"]),
                       float(jm["aux_loss"]), float(m["aux_loss"])))
    ref = stores_from_jax(jax.device_get(ps), jax.device_get(oss))
    return losses, ref, (tps, tos)


def serve_both(jrt, rt, ps_ref, ps, batch, jbatch, s: int, new: int = 4):
    """A prefill then ``new`` greedy decode steps from the grown caches on
    each runtime: [(logits, prefill caches as numpy / tensors, tokens)]
    for the reference, then the port."""
    b = batch["tokens"].shape[0]
    out = []
    for side in ("ref", "port"):
        if side == "ref":
            pre, _ = jax_driver.build_prefill_step(
                jrt, JaxShape("serve", s, b, "decode"))
            logits, caches = pre(ps_ref, jbatch)
            first = jax.device_get(caches)  # decode donates its caches
            caches = jax_driver.grow_caches(
                jrt, caches, s, s + new, JaxShape("serve", s + new, b,
                                                  "decode"))
            dec, _ = jax_driver.build_decode_step(
                jrt, JaxShape("serve", s + new, b, "decode"))
            tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
            stores = ps_ref
        else:
            pre, _ = driver.build_prefill_step(
                rt, InputShape("serve", s, b, "decode"))
            logits, caches = pre(ps, batch)
            first = caches
            dshape = InputShape("serve", s + new, b, "decode")
            caches = driver.grow_caches(rt, caches, s, s + new, dshape)
            dec, _ = driver.build_decode_step(rt, dshape)
            tok = logits[:, 0].argmax(-1)
            stores = ps
        toks = [np.asarray(tok).tolist()]
        for i in range(new):
            pos = jnp.int32(s + i) if side == "ref" else s + i
            tok, caches = dec(stores, caches, tok[:, None], pos)
            toks.append(np.asarray(tok).tolist())
        out.append((np.asarray(logits), first, toks))
    return out


def check_serving(both) -> None:
    """Logits and every prefill cache leaf within 1e-4, tokens
    identical."""
    (jl, jc, jt), (tl, tc, tt) = both
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    for g in tc:
        for (path, a), (_, b) in zip(flatten_with_paths(tc[g]),
                                     flatten_with_paths(jc[g])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4, err_msg=str((g, path)))
    assert tt == jt
