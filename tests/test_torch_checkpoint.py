"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference ``repro.checkpoint.checkpoint`` on the CPU: the same on-disk
format (one ``.npy`` per store part, bf16 as a ``uint16`` view with a
dtype tag, ``manifest.json`` with the layouts), so a checkpoint either
package writes restores in the other with every store identical; a
save, restore and continue equals the uninterrupted run exactly; the
exported param tree equals the reference's; a layout mismatch raises."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jax_mesh  # noqa: E402
from repro.runtime import driver as jax_driver  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro.runtime.step import RuntimeOptions as JaxOptions  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.convert import stores_from_jax  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models.api import flatten_with_paths  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

OPT = dict(os_host_fraction=0.5, weight_decay=0.1)
B, S = 4, 32
SHAPE = InputShape("t", S, B, "train")


def _runtimes(dp=2, chunk_size=None):
    """bf16 stores (the uint16 path), dp=2, half the optimizer groups on
    the host: every kind of part is written."""
    jcfg = jax_config("gpt2-paper-1b", smoke=True)
    cfg = get_config("gpt2-paper-1b", smoke=True)
    jrt = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(dp, 1),
                     JaxOptions(chunk_size=chunk_size, **OPT))
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(dp, 1, device="cpu"),
                        RuntimeOptions(chunk_size=chunk_size, **OPT))
    return jrt, rt


def _batches(cfg, n):
    nxt = make_batch_fn(cfg, B, S, seed=5)
    out = []
    for _ in range(n):
        b = nxt()
        b.pop("mask")
        out.append(b)
    return out


def _jax_state(jrt, steps=1):
    ps, oss = jax_driver.init_state(jrt, jax.random.key(0))
    step, _, _ = jax_driver.build_train_step(jrt, SHAPE)
    for i, b in enumerate(_batches(jrt.cfg, steps)):
        ps, oss, _ = step(ps, oss, {k: jnp.asarray(v) for k, v in b.items()},
                          jnp.int32(i))
    return ps, oss


def _flat(pstores, osstores) -> dict:
    out = {f"param/{k}": v for k, v in pstores.items()}
    for name, streams in osstores.items():
        for k, parts in streams.items():
            for part, t in parts.items():
                out[f"{name}/{k}/{part}"] = t
    return out


def _assert_identical(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_reference_saves_port_restores(tmp_path):
    jrt, rt = _runtimes()
    ps, oss = _jax_state(jrt)
    jax_ckpt.save(jrt, ps, oss, str(tmp_path), step=1)
    tp, tos, step = ckpt.restore(rt, str(tmp_path))
    assert step == 1
    want = _flat(*stores_from_jax(jax.device_get(ps), jax.device_get(oss)))
    _assert_identical(_flat(tp, tos), want)


def test_port_saves_reference_restores(tmp_path):
    jrt, rt = _runtimes()
    tp, tos = driver.place_state(rt, *stores_from_jax(
        *jax.device_get(_jax_state(jrt, steps=0))))
    step, _, _ = driver.build_train_step(rt, SHAPE)
    for i, b in enumerate(_batches(rt.cfg, 2)):
        tp, tos, _ = step(tp, tos, b, i)
    ckpt.save(rt, tp, tos, str(tmp_path), step=2)
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["dtypes"]["param__stem"] == "bfloat16"
    assert man["dtypes"]["os__layers__m__host"] == "float32"
    assert np.load(tmp_path / "param__layers.npy").dtype == np.uint16
    ps, oss, jstep = jax_ckpt.restore(jrt, str(tmp_path))
    assert jstep == 2
    got = _flat(*stores_from_jax(jax.device_get(ps), jax.device_get(oss)))
    _assert_identical(got, _flat(tp, tos))


def test_save_restore_continue_equals_uninterrupted(tmp_path):
    _, rt = _runtimes()
    batches = _batches(rt.cfg, 4)
    step, _, _ = driver.build_train_step(rt, SHAPE)
    p, o = driver.init_state(rt, 0)
    losses = []
    for i, b in enumerate(batches):
        p, o, m = step(p, o, b, i)
        losses.append(float(m["loss"]))
    q, r = driver.init_state(rt, 0)
    for i, b in enumerate(batches[:2]):
        q, r, _ = step(q, r, b, i)
    ckpt.save(rt, q, r, str(tmp_path), step=2)
    del q, r
    _, fresh = _runtimes()
    q, r, at = ckpt.restore(fresh, str(tmp_path))
    step2, _, _ = driver.build_train_step(fresh, SHAPE)
    for i, b in enumerate(batches[at:], start=at):
        q, r, m = step2(q, r, b, i)
        assert float(m["loss"]) == losses[i]
    _assert_identical(_flat(q, r), _flat(p, o))


def test_to_param_tree_matches_reference():
    jrt, rt = _runtimes()
    ps, oss = _jax_state(jrt)
    ref = jax_ckpt.to_param_tree(jrt, ps)
    tp, _ = stores_from_jax(jax.device_get(ps), {})
    got = ckpt.to_param_tree(rt, tp)
    assert len(got["stem"]) == len(ref["stem"]) == 1
    ref_stem = stores_from_jax(jax.device_get(ref["stem"][0]), {})[0]
    ref_layers = stores_from_jax(
        jax.device_get(ref["groups"]["layers"][0]), {})[0]
    for want, have in ((ref_stem, got["stem"][0]),
                       (ref_layers, got["groups"]["layers"][0])):
        wl, hl = flatten_with_paths(want), flatten_with_paths(have)
        assert [p for p, _ in wl] == [p for p, _ in hl]
        for (path, w), (_, h) in zip(wl, hl):
            assert w.dtype == h.dtype and torch.equal(w, h), path


def test_layout_mismatch_raises(tmp_path):
    _, rt = _runtimes()
    p, o = driver.init_state(rt, 0)
    ckpt.save(rt, p, o, str(tmp_path))
    _, other = _runtimes(chunk_size=2 * rt.layouts["layers"].chunk_size)
    with pytest.raises(ValueError, match="layout mismatch"):
        ckpt.restore(other, str(tmp_path))
    _, one_rank = _runtimes(dp=1)
    with pytest.raises(ValueError, match="layout mismatch"):
        ckpt.restore(one_rank, str(tmp_path))
