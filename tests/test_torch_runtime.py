"""The port's chunked-ZeRO runtime (``repro_torch.runtime``) against the
reference ``repro.runtime.step.ChunkedRuntime`` on the CPU.

Both start from one state: the reference's ``driver.init_state``, brought
into the port through ``stores_from_jax``.  Both take the same numpy
batches (``make_batch_fn``) for 3 steps.  Per step the loss is within
1e-5 relative of the reference's in fp32 (2e-2 in bf16).  After the last
step every element of every store part (the params, and p32, m and v in
their device and host parts) is within 1e-5 of the reference's (2e-2 in
bf16), but for at most one in 10^4 elements of a part, and those within
ADAM's own bound: an update moves an element by at most lr (Kingma & Ba,
(1 - b1) < sqrt(1 - b2)) plus the decay, so two runs differ by at most
2 lr (1 + wd |p|) a step.  The exception is fp32 rounding amplified, not
a tolerance for the arithmetic: ADAM's first update is close to sign(g),
so an element whose first gradient is near zero can step the other way
when the two packages sum the same products in another order (ROADMAP
§3).  The option cases are cases of one parametrised test.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jax_mesh  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro.runtime.step import RuntimeOptions as JaxOptions  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import stores_from_jax  # noqa: E402
from repro_torch.core.engine import to_device_batch  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S, STEPS = 4, 32, 3


def _configs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (jax_config("gpt2-paper-1b", smoke=True).replace(**kw),
            get_config("gpt2-paper-1b", smoke=True).replace(**kw))


def _runtimes(dp, dtype="float32", **opt):
    jcfg, cfg = _configs(dtype)
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(dp, 1),
                     JaxOptions(**opt))
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(dp, 1, device="cpu"),
                        RuntimeOptions(**opt))
    return jrt, rt


def _start(jrt, rt):
    """One state for both: the reference's init, converted."""
    ps, oss = jax_driver.init_state(jrt, jax.random.key(0))
    tp, tos = stores_from_jax(jax.device_get(ps), jax.device_get(oss))
    return (ps, oss), driver.place_state(rt, tp, tos)


def _batches(cfg, n=STEPS, b=B):
    nxt = make_batch_fn(cfg, b, S, seed=3)
    out = []
    for _ in range(n):
        b = nxt()
        b.pop("mask")
        out.append(b)
    return out


def _check_part(key, ref, got, tol, adam_bound):
    """Every element within ``tol`` but at most 1e-4 of them, and those
    within ``adam_bound``."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, key
    if not ref.numel():
        return
    err = (ref.double() - got.double()).abs()
    far = int((err > tol).sum())
    assert far <= 1e-4 * ref.numel(), (key, far, float(err.max()))
    assert float(err.max()) <= adam_bound, (key, float(err.max()))


def _parts(pstores, osstores):
    out = {f"param/{k}": v for k, v in pstores.items()}
    for name, streams in osstores.items():
        for k, parts in streams.items():
            for part, t in parts.items():
                out[f"{name}/{k}/{part}"] = t
    return out


CASES = {
    "dp1": dict(dp=1),
    "dp2": dict(dp=2),
    "remat_dots": dict(dp=1, remat="dots"),
    "remat_none": dict(dp=1, remat="none"),
    "gather_step": dict(dp=2, gather_policy="step"),
    "accum2": dict(dp=1, accum_steps=2),
    "xent16": dict(dp=1, xent_block=16),
    "host_half": dict(dp=1, os_host_fraction=0.5),
    "weight_decay": dict(dp=1, weight_decay=0.1),
    "adam_kernel": dict(dp=1, use_adam_kernel=True),
    "dp2_all": dict(dp=2, os_host_fraction=0.5, weight_decay=0.1,
                    xent_block=16, accum_steps=2, use_adam_kernel=True),
    "bf16": dict(dp=2, dtype="bfloat16", os_host_fraction=0.5,
                 weight_decay=0.1, xent_block=16),
    # a batch the ranks do not divide: replicated on every rank
    "batch1_dp2": dict(dp=2, batch=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_runtime_matches_reference(case):
    kw = dict(CASES[case])
    dp, dtype = kw.pop("dp"), kw.pop("dtype", "float32")
    b = kw.pop("batch", B)
    tol = TOL[dtype]
    jrt, rt = _runtimes(dp, dtype, **kw)
    for name, lay in rt.layouts.items():
        assert lay.store_shape == jrt.layouts[name].store_shape
        assert rt.os_split(name) == jrt.os_split(name)
    (ps, oss), (tp, tos) = _start(jrt, rt)
    shape = InputShape("t", S, b, "train")
    jstep, _, _ = jax_driver.build_train_step(jrt, shape)
    step, _, _ = driver.build_train_step(rt, shape)
    for i, batch in enumerate(_batches(rt.cfg, b=b)):
        ps, oss, jm = jstep(ps, oss, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                            jnp.int32(i))
        tp, tos, m = step(tp, tos, batch, i)
        ref, got = float(jm["loss"]), float(m["loss"])
        assert abs(got - ref) <= tol * abs(ref), (i, ref, got)
        assert float(m["aux_loss"]) == float(jm["aux_loss"]) == 0.0
        # a CPU runtime keeps its host part where it is: nothing moves
        assert m["h2d_bytes"] == m["d2h_bytes"] == 0
    ref_parts = _parts(*stores_from_jax(jax.device_get(ps),
                                        jax.device_get(oss)))
    got_parts = _parts(tp, tos)
    assert ref_parts.keys() == got_parts.keys()
    opt = rt.opt
    wd_p = opt.weight_decay * max(float(t.abs().max()) for t in
                                  ref_parts.values() if t.numel())
    bound = max(tol, 2 * STEPS * opt.lr * (1 + wd_p))
    for key, ref in ref_parts.items():
        _check_part(key, ref, got_parts[key], tol, bound)


def test_layer_grads_match_jax_grad():
    """The port's gradient stores (every rank's grads summed, one [G, p,
    S] leaf a layer) equal ``jax.grad`` of the reference's local loss
    under its ``shard_map`` (the reduce-scatter), within 1e-5 of the
    largest gradient."""
    jrt, rt = _runtimes(2)
    (ps, _), (tp, _) = _start(jrt, rt)
    batch = _batches(rt.cfg, 1)[0]
    shape = InputShape("t", S, B, "train")
    _, bps, _ = jax_driver.train_batch_specs(jrt, shape)
    p_ps = jrt.store_pspecs()

    def local_grads(pstores, b):
        return jax.grad(lambda p: jrt._loss_local(p, b)[0])(pstores)

    f = jax.jit(jax_driver._smap(jrt, local_grads, (p_ps, bps), p_ps))
    ref = f(ps, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = stores_from_jax(jax.device_get(ref), {})[0]
    _, _, grads = rt.grads(tp, to_device_batch(batch, "cpu"))
    got = {"stem": grads["stem"][None],
           "layers": torch.stack(grads["layers"])[None]}
    for name in ref:
        scale = float(ref[name].abs().max())
        err = float((ref[name] - got[name]).abs().max())
        assert got[name].dtype == ref[name].dtype
        assert err <= 1e-5 * scale, (name, err, scale)


def test_blockwise_xent_matches_reference():
    """The blockwise head's sum and its gradients against the reference's
    ``blockwise_xent_sum``, on a sequence the block does not divide (the
    padded tail) and with a mask: within 1e-5."""
    from repro.models import layers as jax_layers
    from repro.models.layers import AxisCtx as JaxCtx
    from repro_torch.models import layers as L

    rng = np.random.default_rng(7)
    b, s, d, vocab, block = 2, 20, 16, 48, 8
    table = rng.standard_normal((vocab, d)).astype(np.float32) / 4
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)

    def ref_fn(t, xx):
        return jax_layers.blockwise_xent_sum(
            {"table": t}, xx, jnp.asarray(labels), vocab, JaxCtx(), block,
            mask=jnp.asarray(mask))

    ref, (ref_dt, ref_dx) = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x))
    tt = torch.from_numpy(table).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    got = L.blockwise_xent_sum({"table": tt}, tx,
                               torch.from_numpy(labels).long(), vocab,
                               L.AxisCtx(xent_block=block), block,
                               mask=torch.from_numpy(mask))
    got.backward()
    assert abs(float(got.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    for g, r in ((tt.grad, ref_dt), (tx.grad, ref_dx)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_accum_steps_must_divide_batch():
    """``accum_steps=3`` on a per-rank batch of 4 raises, as the
    reference's does (``tests/test_perf_options.py``)."""
    _, cfg = _configs()
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(1, 1, device="cpu"),
                        RuntimeOptions(accum_steps=3))
    pstores, osstores = driver.init_state(rt, 0)
    step, _, _ = driver.build_train_step(rt, InputShape("t", S, B, "train"))
    with pytest.raises(ValueError, match="accum_steps=3"):
        step(pstores, osstores, _batches(cfg, 1)[0], 0)


def test_batch_must_divide_over_the_ranks():
    """The batch shards over the data ranks only where they divide it; one
    that does not is replicated, as the reference's ``batch_axes`` does:
    every rank runs the whole batch, so the loss (summed over the ranks)
    is the ranks' count times one rank's.  The reference comparison is
    ``test_runtime_matches_reference[batch1_dp2]``."""
    _, cfg = _configs()
    shape = InputShape("t", S, B, "train")
    losses = {}
    for dp in (1, 3):
        rt = ChunkedRuntime(model_class(cfg), cfg,
                            make_smoke_mesh(dp, 1, device="cpu"))
        _, pspecs, _ = driver.train_batch_specs(rt, shape)
        assert pspecs["tokens"] == (None, None)
        step, _, _ = driver.build_train_step(rt, shape)
        ps, os_ = driver.init_state(rt, 0)
        _, _, m = step(ps, os_, _batches(cfg, 1)[0], 0)
        losses[dp] = float(m["loss"])
    assert abs(losses[3] - 3 * losses[1]) <= 1e-5 * losses[3], losses


def test_mesh_refuses_what_is_not_ported():
    """Tensor parallelism and pods are ported (``tests/test_torch_tp*.py``):
    the mesh records them as the reference's does.  The SSM families
    (zamba, xlstm) build at tp 2 too, their model at the mesh's tp
    (``tests/test_torch_tp_ssm*.py``); a size below 1 raises, and so does
    the card where there is none."""
    assert make_smoke_mesh(1, 2, device="cpu").shape == {"data": 1,
                                                         "model": 2}
    mesh = make_smoke_mesh(2, 1, 2, device="cpu")
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.shape == {"pod": 2, "data": 2, "model": 1}
    for arch in ("xlstm-1.3b", "zamba2-1.2b"):
        cfg = get_config(arch, smoke=True)
        rt = ChunkedRuntime(model_class(cfg), cfg,
                            make_smoke_mesh(1, 2, device="cpu"))
        assert rt.ctx.tp == rt.model.ctx.tp == 2
        assert all(rt.store_shape(name)[0] == 2 for name in rt.layouts)
    with pytest.raises(ValueError, match="tp must be"):
        make_smoke_mesh(1, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_smoke_mesh(1, 1)


def test_read_only_batch_is_copied_without_warning():
    """A batch of read-only arrays (``np.asarray`` of a JAX array) goes to
    the device without torch's non-writable-array warning, and without
    sharing the caller's memory."""
    tok = np.asarray(jnp.arange(12, dtype=jnp.int32).reshape(3, 4))
    assert not tok.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        out = to_device_batch({"tokens": tok, "global_tokens":
                               np.float32(12)}, "cpu")
    assert out["tokens"].dtype == torch.int64
    assert out["tokens"].tolist() == tok.tolist()
    assert out["global_tokens"] == 12.0


def test_init_state_master_weights_from_the_param_store():
    """The fp32 master weights are the bf16 param store read as fp32 (the
    reference's ``init_state``), m and v zero, parts shaped as
    ``os_specs``; the store unflattens back to the params."""
    from repro_torch.core import zero
    from repro_torch.models.api import flatten_with_paths

    _, cfg = _configs("bfloat16")
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(2, 1, device="cpu"),
                        RuntimeOptions(os_host_fraction=0.5))
    params = rt.model.init_params(torch.Generator().manual_seed(1))
    pstores, osstores = driver.init_state(rt, params=params)
    specs = rt.os_specs()
    for name in rt.layouts:
        dev_g, _ = rt.os_split(name)
        head, tail = zero.split_groups(pstores[name], dev_g)
        assert torch.equal(osstores[name]["p32"]["dev"], head.float())
        assert torch.equal(osstores[name]["p32"]["host"], tail.float())
        for k in ("p32", "m", "v"):
            for part in ("dev", "host"):
                t = osstores[name][k][part]
                assert t.shape == specs[name][k][part].shape
                assert t.dtype == torch.float32 and t.is_contiguous()
                if k != "p32":
                    assert not t.any()
    back = zero.unflatten_from_store(rt.layouts["layers"],
                                     pstores["layers"][0, 1])
    want = {p: t[1] for p, t in flatten_with_paths(
        params["groups"]["layers"])}
    for path, t in flatten_with_paths(back):
        assert torch.equal(t, want[path].to(torch.bfloat16))


def test_train_cli_runs_and_checkpoints(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: the reference's
    per-step line, and a checkpoint the reference restores."""
    from repro.checkpoint import checkpoint as jax_ckpt
    from repro_torch.launch import train

    train.main(["--device", "cpu", "--smoke", "--steps", "2", "--batch",
                "4", "--seq", "32", "--dp", "2", "--xent-block", "16",
                "--os-host-fraction", "0.5", "--weight-decay", "0.1",
                "--devices", "8", "--checkpoint", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=gpt2-paper-smoke mesh={'data': 2, "
                             "'model': 1}")
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 2 and "loss" in steps[0] and "aux 0.0000" in \
        steps[0]
    jrt, _ = _runtimes(2, "bfloat16", os_host_fraction=0.5)
    ps, oss, at = jax_ckpt.restore(jrt, str(tmp_path))
    assert at == 2
    assert ps["layers"].shape == jrt.store_specs()["layers"].shape
