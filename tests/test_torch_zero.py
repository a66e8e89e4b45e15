"""The port's chunked ZeRO store (``repro_torch.core.zero``) against the
reference ``repro.core.zero``: twins of ``tests/test_zero.py`` (the
flatten round trip over the same ``nproc`` cases, the gather and its
gradient as the reduce-scatter, the communication-volume model,
split/merge), the stores both packages build from one tree compared
element for element, and the layouts of gpt2-paper-1b at full size
compared field for field (shapes only: nothing is allocated)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.core import zero as jax_zero  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jax_mesh  # noqa: E402
from repro.runtime.step import ChunkedRuntime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.core import zero  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime  # noqa: E402


def _tree(seed: int) -> dict:
    """``tests/test_zero.py``'s tree strategy, drawn with numpy."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i in range(int(rng.integers(1, 9))):
        shape = tuple(int(d) for d in rng.integers(1, 7, size=int(
            rng.integers(1, 4))))
        tree[f"w{i}"] = (np.arange(int(np.prod(shape)), dtype=np.float32)
                         .reshape(shape) + i)
    return tree


@pytest.mark.parametrize("nproc", [1, 2, 4])
@pytest.mark.parametrize("seed", range(4))
def test_flatten_roundtrip_matches_reference(seed, nproc):
    tree = _tree(seed)
    largest = max(v.size for v in tree.values())
    size = max(largest, 8)
    layout = zero.make_layout({k: torch.from_numpy(v)
                               for k, v in tree.items()},
                              nproc=nproc, dtype=torch.float32,
                              chunk_size=size)
    ref_layout = jax_zero.make_layout(tree, nproc=nproc, dtype=jnp.float32,
                                      chunk_size=size)
    store = zero.flatten_to_store(
        layout, {k: torch.from_numpy(v) for k, v in tree.items()})
    assert tuple(store.shape) == layout.store_shape == ref_layout.store_shape
    ref_store = np.asarray(jax_zero.flatten_to_store(ref_layout, tree))
    np.testing.assert_array_equal(store.numpy(), ref_store)
    back = zero.unflatten_from_store(layout, store)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])


def test_gather_and_grad_reduce_scatter():
    """The simulated all-gather (a view of the store in chunk-id order)
    and its gradient summed over the ranks' losses (the reduce-scatter):
    four ranks each computing sum(x^2) give 4 x 2 x store, as the
    reference's shard_map test does."""
    tree = {"a": torch.arange(24, dtype=torch.float32).reshape(4, 6),
            "b": torch.ones(5)}
    layout = zero.make_layout(tree, nproc=4, dtype=torch.float32,
                              chunk_size=32)
    store = zero.flatten_to_store(layout, tree)
    leaf = store.clone().requires_grad_()
    total, grad = 0.0, torch.zeros_like(store)
    for _ in range(4):
        params = zero.gather_params(layout, leaf)
        val = sum((x ** 2).sum() for x in params.values())
        grad += torch.autograd.grad(val, leaf)[0]
        total += float(val.detach())
    assert total / 4 == pytest.approx(
        sum(float((x ** 2).sum()) for x in tree.values()))
    torch.testing.assert_close(grad, 4 * 2 * store, rtol=1e-6, atol=0)
    flat = zero.gather_store(store)
    assert flat.data_ptr() == store.data_ptr() and flat.shape == (4 * 32,)


def test_comm_volume_model_matches_reference():
    specs = {"w": torch.zeros((64, 64))}
    layout = zero.make_layout(specs, nproc=8, dtype=torch.bfloat16,
                              chunk_size=4096)
    ref = jax_zero.make_layout({"w": jnp.zeros((64, 64))}, nproc=8,
                               dtype=jnp.bfloat16, chunk_size=4096)
    vol = zero.comm_volume_bytes(layout)
    assert vol == jax_zero.comm_volume_bytes(ref)
    m = 64 * 64 * 2
    assert vol["params_bytes"] == m
    assert abs(vol["chunked_allgather_bytes"] - 3 * (7 / 8) * m) < 1e-6
    assert vol["broadcast_baseline_bytes"] > vol["chunked_allgather_bytes"] \
        * 1.6


def test_split_merge_groups():
    store = torch.arange(2 * 3 * 4 * 8, dtype=torch.float32).reshape(
        2, 3, 4, 8)  # [L=2, G=3, p=4, S=8]
    dev, host = zero.split_groups(store, 2)
    assert dev.shape == (2, 2, 4, 8) and host.shape == (2, 1, 4, 8)
    assert torch.equal(zero.merge_groups(dev, host), store)
    ref_dev, ref_host = jax_zero.split_groups(jnp.asarray(store.numpy()), 2)
    np.testing.assert_array_equal(dev.numpy(), np.asarray(ref_dev))
    np.testing.assert_array_equal(host.numpy(), np.asarray(ref_host))


def _layout_fields(lay) -> dict:
    cmap = lay.cmap
    return dict(
        chunk_size=lay.chunk_size, nproc=lay.nproc,
        num_groups=lay.num_groups, store_shape=tuple(lay.store_shape),
        capacity=lay.capacity, payload_elems=lay.payload_elems,
        names=tuple(lay.names), shapes=tuple(lay.shapes),
        dtype=getattr(lay.dtype, "__name__", str(lay.dtype).split(".")[-1]),
        utilization=cmap.utilization,
        placements=tuple((p.name, tuple(p.shape), p.chunk_id, p.offset)
                         for p in cmap.placements),
        offsets={n: lay.flat_offset(n) for n in lay.names})


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_full_size_layouts_match_reference(nproc):
    """gpt2-paper-1b at full depth and width: the stem's and the layer
    group's layouts (chunk size from the search, G, padding, every
    tensor's chunk and offset) and the optimizer-state split, field for
    field."""
    jcfg = jax_config("gpt2-paper-1b")
    cfg = get_config("gpt2-paper-1b")
    ref = JaxRuntime(jax_model_class(jcfg), jcfg, jax_mesh(nproc, 1))
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(nproc, 1, device="cpu"))
    assert set(rt.layouts) == set(ref.layouts) == {"stem", "layers"}
    for name in rt.layouts:
        assert _layout_fields(rt.layouts[name]) == \
            _layout_fields(ref.layouts[name]), name
        assert rt.store_shape(name) == ref.store_specs()[name].shape
        assert rt.os_split(name) == ref.os_split(name)
    specs = rt.store_specs()
    assert all(t.device.type == "meta" for t in specs.values())
    assert rt.model.tp_axes() == ref.tp_axes
