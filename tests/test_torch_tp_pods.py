"""The port's chunked runtime with pods, against the reference's runtime
from its own ``init_state`` stores on the CPU (pods 2 x tp 2, one step),
and the conversion of the reference's tp = 2 and tp = 4 stores as they
are (``tests/_torch_tp.py`` sets out the gradient scale and the
tolerances)."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import stores_from_jax  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402

import _torch_tp as H  # noqa: E402

B, S = H.B, H.S


def test_pods2_tp2_step_matches_reference():
    """pods 2 x dp 1 x tp 2, one step: the batch over (pod, data) as the
    reference's ``batch_axes`` splits it, the gradients summed over the
    pods; the loss and every store part as the reference's."""
    jrt, rt = H.runtimes("qwen2.5-3b", 1, 2, pods=2)
    # the reference's batch_axes: over "pod" (4 rows, 2 pods), "data"
    # adds nothing at dp = 1
    assert driver.train_batch_specs(rt, InputShape("t", S, B, "train"))[
        1]["tokens"] == (("pod",), None)
    assert rt.batch_shards(B) == [[(0, 2)], [(2, 4)]]
    H.oracle_scale(jrt, 2 * 2)
    losses, ref, got = H.run_both(jrt, rt, H.batches(rt.cfg, 1))
    jl, tl, _, _ = losses[0]
    assert abs(tl - jl) <= 1e-5 * abs(jl), (jl, tl)
    H.check_stores(ref, got, 1)
    assert H.replicated_equal(rt, *got) > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_stores_from_jax_takes_tp_stores_as_they_are(tp):
    """The reference's tp = 2 and tp = 4 stores (its ``init_state``: the
    sharded leaves drawn per rank, the replicated ones shared) convert
    leaf for leaf: the port's layouts give the same ``[tp, ...]`` shapes,
    the values survive exactly, and every replicated leaf's copies are
    bitwise equal across the ranks, as the port keeps them."""
    jrt, rt = H.runtimes("qwen2.5-3b", 2, tp)
    (ps, oss), (tps, tos) = H.start(jrt, rt)
    ref = H.store_parts(*stores_from_jax(jax.device_get(ps), jax.device_get(oss)))
    got = H.store_parts(tps, tos)
    for key, r in ref.items():
        assert torch.equal(got[key], r), key
    assert tuple(tps["stem"].shape) == rt.store_shape("stem")
    assert tps["stem"].shape[0] == tp
    assert H.replicated_equal(rt, tps, tos) > 0
