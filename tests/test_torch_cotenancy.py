"""Co-tenancy on the port (``repro_torch.cotenancy``) against the
reference's own functions (``benchmarks/cotenancy.py``: ``solo_serving``,
``solo_training``, ``coresident``, ``static_split``), at its budgets and
smoke configurations with fewer requests, tokens and steps, on the same
weights (the reference's ``init_params(jax.random.key(0))``) and on a
calibrated timeline priced with the reference's constants, on the CPU.

Equal to the reference: tokens, losses (1e-5), every round's and step's
modelled wall, cross-evictions, per-tenant device peaks and h2d bytes.
And the reference's bars on the port: co-resident tokens equal solo
tokens (1), the serve tenant within its budgets every round with no serve
chunk evicted for the trainer (2; checked inside the functions), the
modelled latency and throughput ratios (3, 4), co-resident losses equal
solo losses (4), and the static 50/50 split failing where the
reference's fails (5)."""

import importlib.util
import statistics
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models.layers import AxisCtx  # noqa: E402
from _torch_parity import reference_hardware  # noqa: E402
from repro_torch import cotenancy as co  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.timeline import TransferTimeline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HW = reference_hardware()
N_REQ, NEW_TOKENS, STEPS = 4, 4, 3


@pytest.fixture(scope="module")
def ref():
    """The reference benchmark module (it imports ``benchmarks.common``,
    so the repository root joins the path while it loads)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        spec = importlib.util.spec_from_file_location(
            "reference_cotenancy", ROOT / "benchmarks" / "cotenancy.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup(ref):
    from repro.configs import model_class as jax_model_class

    def port_params(jcfg):
        return params_from_jax(jax.tree.map(
            np.asarray, jax_model_class(jcfg)(jcfg, AxisCtx()).init_params(
                jax.random.key(0))))

    sj, tj = ref._serve_cfg(), ref._train_cfg()
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    scfg = get_config("qwen3-0.6b", smoke=True).replace(**fp32)
    tcfg = get_config("gpt2-paper-1b", smoke=True).replace(num_layers=3,
                                                           **fp32)
    prompts = np.asarray(jax.random.randint(
        jax.random.key(5), (N_REQ, 8), 0, sj.vocab_size))
    batch = {k: np.asarray(v) for k, v in
             ref.lm_batch(tj, ref.BATCH, ref.SEQ).items()}
    shares = co.Shares(serve_device=ref.SERVE_DEVICE,
                       serve_host=ref.SERVE_HOST,
                       train_device=ref.TRAIN_DEVICE,
                       device_pool=ref.DEVICE_POOL, host_pool=ref.HOST_POOL)
    serve_kw = dict(max_seq_len=ref.HORIZON, page_tokens=ref.PAGE_TOKENS)
    return dict(scfg=scfg, sparams=port_params(sj), tcfg=tcfg,
                tparams=port_params(tj), prompts=list(prompts),
                batches=[batch] * STEPS, shares=shares, serve_kw=serve_kw)


def _lat(rounds):
    return [m.timeline.wall_s for m in rounds]


def _walls(steps):
    return [m.timeline.wall_s for m in steps]


def test_coresident_matches_reference_and_holds_the_bars(ref, setup):
    s = setup
    sh = s["shares"]
    solo_s = co.solo_serving(
        s["scfg"], s["sparams"], s["prompts"], NEW_TOKENS,
        device_bytes=sh.serve_device, host_bytes=sh.serve_host,
        timeline=TransferTimeline.calibrated(HW), device="cpu",
        **s["serve_kw"])
    solo_t = co.solo_training(
        s["tcfg"], s["tparams"], s["batches"], device_bytes=sh.train_device,
        host_bytes=sh.host_pool, timeline=TransferTimeline.calibrated(HW),
        device="cpu")
    serve, train, report = co.coresident(
        s["scfg"], s["sparams"], s["prompts"], NEW_TOKENS, s["tcfg"],
        s["tparams"], s["batches"], sh,
        timeline=TransferTimeline.calibrated(HW), device="cpu",
        serve_kw=s["serve_kw"])

    ref_solo_toks, ref_solo_lat = ref.solo_serving(s["prompts"], NEW_TOKENS)
    ref_solo_losses, ref_solo_walls = ref.solo_training(STEPS)
    ref_toks, ref_lat, ref_losses, ref_walls, ref_report = ref.coresident(
        s["prompts"], NEW_TOKENS, STEPS)

    # the reference's numbers, run for run
    assert solo_s.tokens == ref_solo_toks and serve.tokens == ref_toks
    assert _lat(solo_s.rounds) == ref_solo_lat
    assert _lat(serve.rounds) == ref_lat
    assert _walls(solo_t.steps) == ref_solo_walls
    assert _walls(train.steps) == ref_walls
    np.testing.assert_allclose(solo_t.losses, ref_solo_losses, rtol=1e-5)
    np.testing.assert_allclose(train.losses, ref_losses, rtol=1e-5)
    assert report == dict(ref_report, serve_d2h_bytes=report[
        "serve_d2h_bytes"], train_d2h_bytes=report["train_d2h_bytes"])
    assert report["cross_evictions"].get("serve<-train", 0) == 0

    # the bars, on the port
    assert serve.tokens == solo_s.tokens  # 1
    np.testing.assert_allclose(train.losses, solo_t.losses, rtol=1e-6)  # 4
    lat_ratio = statistics.mean(_lat(serve.rounds)) / statistics.mean(
        _lat(solo_s.rounds))
    tp_ratio = co.throughput(_walls(train.steps)) / co.throughput(
        _walls(solo_t.steps))
    assert lat_ratio <= ref.LATENCY_BAR, lat_ratio  # 3
    assert tp_ratio >= ref.THROUGHPUT_BAR, tp_ratio  # 4


def test_static_split_fails_where_the_reference_fails(ref, setup):
    s = setup
    serve, train, oom = co.static_split(
        s["scfg"], s["sparams"], s["prompts"], NEW_TOKENS, s["tcfg"],
        s["tparams"], s["batches"], s["shares"],
        timeline_factory=lambda: TransferTimeline.calibrated(HW),
        device="cpu", serve_kw=s["serve_kw"])
    ref_toks, ref_lat, ref_walls, ref_oom = ref.static_split(
        s["prompts"], NEW_TOKENS, STEPS)
    assert oom == ref_oom is True and train is None  # bar 5
    assert serve.tokens == ref_toks
    assert _lat(serve.rounds) == ref_lat
