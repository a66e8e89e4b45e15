"""The port's chunked-ZeRO runtime on the card against itself on the CPU
(chip_smoke's ``rt_parity``, fp32, dp=1): gpt2-paper-1b's smoke config,
half the optimizer groups on the host, weight decay 0.1, the blockwise
head; per-step losses within 1e-4 relative, the same collective counts,
the host part's bytes moved each way, and K2 and K1 launched exactly as
the plan implies.  Needs a card; skips without one."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.kernels import chunked_adam as ka  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models.layers import AxisCtx  # noqa: E402
from repro_torch.runtime import driver  # noqa: E402
from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions  # noqa: E402

OPT = RuntimeOptions(os_host_fraction=0.5, weight_decay=0.1, xent_block=16)


def _train(cfg, params, batches, device):
    rt = ChunkedRuntime(model_class(cfg), cfg,
                        make_smoke_mesh(1, 1, device=device), OPT)
    b, s = batches[0]["tokens"].shape
    step, _, _ = driver.build_train_step(rt, InputShape("t", s, b, "train"))
    ps, os_ = driver.init_state(rt, params=params)
    mets = []
    for i, batch in enumerate(batches):
        ps, os_, m = step(ps, os_, batch, i)
        mets.append(dict(m, loss=float(m["loss"])))
    return rt, mets


@pytest.mark.gpu
def test_card_runtime_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gpt2-paper-1b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    params = model_class(cfg)(cfg, AxisCtx()).init_params(
        torch.Generator().manual_seed(0))
    nxt = make_batch_fn(cfg, 4, 32)
    batches = [{k: v for k, v in nxt().items() if k != "mask"}
               for _ in range(3)]
    _, cpu = _train(cfg, params, batches, "cpu")
    fa.launches = fa.bwd_launches = ka.launches = 0
    rt, gpu = _train(cfg, params, batches, "cuda")
    launches = (fa.launches, fa.bwd_launches, ka.launches)
    host = sum((1 if n == "stem" else rt.group_lengths[n])
               * rt.os_split(n)[1] * lay.chunk_size
               for n, lay in rt.layouts.items())
    for a, b in zip(cpu, gpu):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(a["loss"])
        assert a["collectives"] == b["collectives"]
        assert b["h2d_bytes"] == b["d2h_bytes"] == 12 * host > 0
    layers, steps = cfg.num_layers, len(batches)
    k1 = sum((1 if n == "stem" else rt.group_lengths[n])
             * sum(1 for g in rt.os_split(n) if g) for n in rt.layouts)
    assert launches == (2 * layers * steps, layers * steps, k1 * steps)
