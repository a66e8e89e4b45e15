"""The port's tensor-parallel layers (``repro_torch.models.tp`` and the
model axis of ``repro_torch.models.layers``, ``mla``) against the
reference's under its own ``shard_map`` on the CPU devices that
``tests/conftest.py`` gives, and against the tp=1 oracle.

Inputs come from a numpy seed.  A sharded param is handed to the port as
a ``Ranks`` of the reference's per-rank slices; the reference reads the
same slices inside ``shard_map``.  Outputs the reference holds per rank
(caches) come back stacked along the model axis.  fp32 cases hold 1e-5
of the output's scale against both (the reference test's own 2e-4 is for
its scan twin); bf16 cases hold the reference's rounding: the fp32 psum
of the ranks' partials, then one cast.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch.nn.functional as F  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import model_class as jax_model_class  # noqa: E402
from repro.configs.base import BaseConfig as JaxBase  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoE  # noqa: E402
from repro.launch.mesh import _mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import tp as jtp  # noqa: E402
from repro.models.layers import shard_map_compat  # noqa: E402
from repro_torch.configs import get_config, model_class  # noqa: E402
from repro_torch.configs.base import BaseConfig, MoEConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import tp as TP  # noqa: E402
from repro_torch.models.api import flatten_with_paths  # noqa: E402
from repro_torch.models.tp import Ranks  # noqa: E402

TOL = 1e-5


def _mesh_of(tp):
    return _mesh((1, tp), ("data", "model"))


def _ctx(tp):
    return JL.AxisCtx(model_axis="model", tp=tp, data_axis="data", dp=1)


def _smap(fn, tp, out_specs):
    return jax.jit(shard_map_compat(fn, mesh=_mesh_of(tp), in_specs=(P(),),
                                    out_specs=out_specs, check_vma=False))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, scale=None, tol=TOL):
    got = np.asarray(got.detach().float() if hasattr(got, "detach")
                     else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    s = scale if scale is not None else max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * s, (err, s)


def _rank_slices(w, width, axis, tp):
    """The tp ranks' slices of ``w`` along ``axis``, ``width`` a rank."""
    return [np.take(w, np.arange(r * width, (r + 1) * width), axis=axis)
            for r in range(tp)]


def _attn_weights(rng, d, h, kv, hd):
    return {"wq": rng.standard_normal((d, h * hd)).astype(np.float32)
            / np.sqrt(d),
            "wk": rng.standard_normal((d, kv * hd)).astype(np.float32)
            / np.sqrt(d),
            "wv": rng.standard_normal((d, kv * hd)).astype(np.float32)
            / np.sqrt(d),
            "wo": rng.standard_normal((h * hd, d)).astype(np.float32)
            / np.sqrt(h * hd)}


def _port_attn(w, h, kv, hd, tp):
    """The port's tp param tree: Ranks of each rank's head slice; wk/wv
    replicated (rank 0's copy alone) where kv does not divide tp."""
    h_l = h // tp
    p = {"wq": Ranks(_t(a) for a in _rank_slices(w["wq"], h_l * hd, 1, tp)),
         "wo": Ranks(_t(a) for a in _rank_slices(w["wo"], h_l * hd, 0, tp))}
    for k in ("wk", "wv"):
        p[k] = (Ranks(_t(a) for a in _rank_slices(w[k], kv // tp * hd, 1,
                                                   tp))
                if kv % tp == 0 else _t(w[k]))
    return p


def _jax_rank_attn(w, h, kv, hd, tp):
    """Inside shard_map: this rank's slices of the same weights."""
    rank = jax.lax.axis_index("model")
    h_l = h // tp
    sl = jax.lax.dynamic_slice_in_dim
    p = {"wq": sl(jnp.asarray(w["wq"]), rank * h_l * hd, h_l * hd, 1),
         "wo": sl(jnp.asarray(w["wo"]), rank * h_l * hd, h_l * hd, 0)}
    for k in ("wk", "wv"):
        p[k] = (sl(jnp.asarray(w[k]), rank * (kv // tp) * hd,
                   (kv // tp) * hd, 1) if kv % tp == 0
                else jnp.asarray(w[k]))
    return p


def _stack(ranks_tree):
    """A port cache tree with Ranks leaves -> leaves stacked [tp, ...]."""
    return {k: torch.stack(list(v)) for k, v in ranks_tree.items()}


@pytest.mark.parametrize("h,kv,tp", [(8, 2, 4), (8, 8, 4), (4, 2, 2)])
def test_tp_attention_fwd_prefill_decode(h, kv, tp):
    """Attention at the reference test's three (h, kv, tp) cases: the
    full-sequence forward, the prefill and its per-rank caches, and a
    token-by-token decode from empty caches (the "dist" plan where kv
    does not divide tp) against the reference's ``shard_map`` run, rank
    by rank for the caches, and against the tp=1 oracle."""
    d, hd, B, S = 64, 16, 2, 12
    rng = np.random.default_rng(0)
    w = _attn_weights(rng, d, h, kv, hd)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    kw = dict(name="t", d_model=d, n_heads=h, n_kv_heads=kv, head_dim=hd,
              d_ff=64, vocab_size=64)
    jcfg, cfg = JaxBase(**kw), BaseConfig(**kw)
    ctx = L.AxisCtx(tp=tp)

    def run(xx):
        p = _jax_rank_attn(w, h, kv, hd, tp)
        jctx = _ctx(tp)
        y_fwd = JL.attention_fwd(p, xx, jcfg, jctx)
        y_pre, cache = JL.attention_prefill(p, xx, jcfg, jctx)
        c2 = JL.attention_init_cache(jcfg, B, S, tp, jnp.float32)
        y_dec = None
        for i in range(S):
            y_dec, c2 = JL.attention_decode(p, xx[:, i:i + 1], c2, i, jcfg,
                                            jctx)
        return (y_fwd, y_pre, y_dec,
                jax.tree.map(lambda t: t[None], cache),
                jax.tree.map(lambda t: t[None], c2))

    want = _smap(run, tp, (P(), P(), P(), P("model"), P("model")))(
        jnp.asarray(x))
    oracle = L.attention_fwd({k: _t(v) for k, v in w.items()}, _t(x), cfg,
                             L.AxisCtx())
    p = _port_attn(w, h, kv, hd, tp)
    tx = _t(x)
    y_fwd = L.attention_fwd(p, tx, cfg, ctx)
    y_pre, cache = L.attention_prefill(p, tx, cfg, ctx)
    c2 = TP.ranks_tree([L.attention_init_cache(cfg, B, S, tp,
                                               torch.float32)
                        for _ in range(tp)])
    y_dec = None
    for i in range(S):
        y_dec, c2 = L.attention_decode(p, tx[:, i:i + 1], c2, i, cfg, ctx)
    scale = float(oracle.abs().max())
    for got, ref in ((y_fwd, want[0]), (y_pre, want[1])):
        _close(got, ref, scale)
        _close(got, oracle.numpy(), scale)
    _close(y_dec[:, 0], np.asarray(want[2])[:, 0], scale)
    _close(y_dec[:, 0], oracle[:, -1].numpy(), scale)
    for got, ref in ((_stack(cache), want[3]), (_stack(c2), want[4])):
        for k in ("k", "v"):
            _close(got[k], ref[k])


def test_tp_prefill_then_decode_continues_dist_cache():
    """Decode continuing from a prefilled "dist" cache (kv % tp != 0),
    grown to the decode horizon, against the reference's and the tp=1
    oracle's last position (the reference's
    ``test_prefill_then_decode_continues``)."""
    d, h, kv, hd, tp, B, S = 64, 8, 2, 16, 4, 2, 8
    rng = np.random.default_rng(3)
    w = _attn_weights(rng, d, h, kv, hd)
    x = rng.standard_normal((B, S + 2, d)).astype(np.float32)
    kw = dict(name="t", d_model=d, n_heads=h, n_kv_heads=kv, head_dim=hd,
              d_ff=64, vocab_size=64)
    jcfg, cfg = JaxBase(**kw), BaseConfig(**kw)
    assert L.decode_cache_plan(cfg, tp) == JL.decode_cache_plan(jcfg, tp) \
        == ("dist", 1, 2)

    def run(xx):
        p = _jax_rank_attn(w, h, kv, hd, tp)
        jctx = _ctx(tp)
        _, cache = JL.attention_prefill(p, xx[:, :S], jcfg, jctx)
        full = JL.attention_init_cache(jcfg, B, S + 2, tp, cache["k"].dtype)
        cache = {k2: jax.lax.dynamic_update_slice(full[k2], cache[k2],
                                                  (0, 0, 0, 0))
                 for k2 in cache}
        y = None
        for i in range(2):
            y, cache = JL.attention_decode(p, xx[:, S + i:S + i + 1], cache,
                                           S + i, jcfg, jctx)
        return y

    want = _smap(run, tp, P())(jnp.asarray(x))
    oracle = L.attention_fwd({k: _t(v) for k, v in w.items()}, _t(x), cfg,
                             L.AxisCtx())
    ctx = L.AxisCtx(tp=tp)
    p = _port_attn(w, h, kv, hd, tp)
    tx = _t(x)
    _, cache = L.attention_prefill(p, tx[:, :S], cfg, ctx)
    grown = []
    for r in range(tp):
        full = L.attention_init_cache(cfg, B, S + 2, tp, torch.float32)
        for k2 in full:
            part = cache[k2][r]
            full[k2][:, :part.shape[1]] = part
        grown.append(full)
    cache = TP.ranks_tree(grown)
    y = None
    for i in range(2):
        y, cache = L.attention_decode(p, tx[:, S + i:S + i + 1], cache,
                                      S + i, cfg, ctx)
    scale = float(oracle.abs().max())
    _close(y[:, 0], np.asarray(want)[:, 0], scale)
    _close(y[:, 0], oracle[:, -1].numpy(), scale)


def test_tp_mla_decode_matches_fwd():
    """MLA's absorbed decode at tp = 4 (the latent cache in strided
    sequence chunks, the cross-rank softmax combine) against its own
    forward at tp=1 and against the reference's decode under
    ``shard_map`` (the reference's ``test_mla_decode_matches_fwd``)."""
    tp, B, S = 4, 2, 10
    kw = dict(name="mla-t", d_model=64, n_heads=4, n_kv_heads=4,
              head_dim=32, d_ff=64, d_ff_expert=32, vocab_size=64,
              kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
              n_experts=4, top_k=2)
    jcfg, cfg = JaxMoE(**kw), MoEConfig(**kw)
    rng = np.random.default_rng(1)
    shapes = {"wq": (64, 4 * 24), "w_dkv": (64, 16), "w_krope": (64, 8),
              "w_uk": (16, 4 * 16), "w_uv": (16, 4 * 16), "wo": (4 * 16, 64)}
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    w["kv_norm"] = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    widths = {"wq": (24, 1), "w_uk": (16, 1), "w_uv": (16, 1), "wo": (16, 0)}

    def run(xx):
        rank = jax.lax.axis_index("model")
        p = {k: jnp.asarray(v) for k, v in w.items()}
        for k, (wd, ax) in widths.items():
            p[k] = jax.lax.dynamic_slice_in_dim(p[k], rank * wd, wd, ax)
        jctx = _ctx(tp)
        cache = JMLA.mla_init_cache(jcfg, B, S, jnp.float32, tp=tp)
        y = None
        for i in range(S):
            y, cache = JMLA.mla_decode(p, xx[:, i:i + 1], cache, i, jcfg,
                                       jctx)
        return y, jax.tree.map(lambda t: t[None], cache)

    want, want_cache = _smap(run, tp, (P(), P("model")))(jnp.asarray(x))
    oracle = MLA.mla_fwd({k: _t(v) for k, v in w.items()}, _t(x), cfg,
                         L.AxisCtx())
    p = {k: _t(v) for k, v in w.items()}
    for k, (wd, ax) in widths.items():
        p[k] = Ranks(_t(a) for a in _rank_slices(w[k], wd, ax, tp))
    ctx = L.AxisCtx(tp=tp)
    cache = TP.ranks_tree([MLA.mla_init_cache(cfg, B, S, torch.float32,
                                              tp=tp) for _ in range(tp)])
    tx = _t(x)
    y = None
    for i in range(S):
        y, cache = MLA.mla_decode(p, tx[:, i:i + 1], cache, i, cfg, ctx)
    scale = float(oracle.abs().max())
    _close(y[:, 0], np.asarray(want)[:, 0], scale)
    _close(y[:, 0], oracle[:, -1].numpy(), scale)
    got = _stack(cache)
    for k in ("c", "k_pe"):
        _close(got[k], want_cache[k])
    with pytest.raises(ValueError, match="MLA heads"):
        MLA.init_mla(torch.Generator(), cfg, 3)


def test_vocab_parallel_head_over_a_padded_vocab():
    """The vocab-parallel head at a vocab tp does not divide (510 over 4:
    ``ceil`` rows a rank, the last rank's 2 rows padding), against the
    reference's under ``shard_map``: the per-token cross-entropy (masked)
    and the blockwise sum over a sequence the block does not divide; the
    sum's gradient against the tp=1 head's over the unpadded table (the
    padding rows' zero); and the greedy token with a tie across two shards (the
    lowest global id wins) and a padded row that would win were it not
    masked."""
    tp, vocab, d, b, s = 4, 510, 16, 2, 10
    vl = -(-vocab // tp)
    rng = np.random.default_rng(7)
    table = (rng.standard_normal((tp * vl, d)) / 4).astype(np.float32)
    table[vocab:] = 0.0
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    logits = rng.standard_normal((b, 1, tp * vl)).astype(np.float32)
    logits[0, 0, [100, 300]] = 9.0  # a tie across ranks 0 and 2
    logits[1, 0, 511] = 50.0  # a padded row
    logits[1, 0, 200] = 8.0

    def run(_):
        rank = jax.lax.axis_index("model")
        jctx = _ctx(tp)
        tl = {"table": jax.lax.dynamic_slice_in_dim(jnp.asarray(table),
                                                    rank * vl, vl, 0)}
        ll = JL.lm_logits_local(tl, jnp.asarray(x), jctx)
        per_tok = JL.vocab_parallel_xent(ll, jnp.asarray(labels), vocab,
                                         jctx, mask=jnp.asarray(mask))
        blk = JL.blockwise_xent_sum(tl, jnp.asarray(x), jnp.asarray(labels),
                                    vocab, jctx, 4, mask=jnp.asarray(mask))
        gl = jax.lax.dynamic_slice_in_dim(jnp.asarray(logits), rank * vl,
                                          vl, 2)
        tok = JL.greedy_token(gl, vocab, jctx)
        return per_tok, blk, tok

    per_tok, blk, tok = _smap(run, tp, (P(), P(), P()))(jnp.zeros(()))
    assert np.asarray(tok).tolist() == [100, 200]
    ctx = L.AxisCtx(tp=tp)
    shards = [_t(a).requires_grad_() for a in
              _rank_slices(table, vl, 0, tp)]
    tl = {"table": Ranks(shards)}
    tx, tlab = _t(x), _t(labels).long()
    got = L.vocab_parallel_xent(L.lm_logits_local(tl, tx, ctx), tlab, vocab,
                                ctx, mask=_t(mask))
    _close(got, per_tok)
    tot = L.blockwise_xent_sum(tl, tx, tlab, vocab, ctx, 4, mask=_t(mask))
    _close(tot, blk)
    # the blockwise sum and its gradient against the tp=1 head over the
    # unpadded table
    full = _t(table[:vocab]).requires_grad_()
    one = L.blockwise_xent_sum({"table": full}, tx, tlab, vocab,
                               L.AxisCtx(), 4, mask=_t(mask))
    _close(tot, one.detach().numpy())
    tot.backward()
    one.backward()

    grad = torch.cat([t.grad for t in shards])
    _close(grad[:vocab], full.grad.numpy())
    assert float(grad[vocab:].abs().max()) == 0.0
    gl = Ranks(_t(a) for a in _rank_slices(logits, vl, 2, tp))
    assert L.greedy_token(gl, vocab, ctx).tolist() == [100, 200]


def test_bf16_psum_then_one_cast():
    """``embed_lookup`` and ``mlp_fwd`` in bf16 at tp = 2, against the
    reference's: each rank's fp32 partial, the fp32 psum, then one cast
    to bf16.  The lookup (one rank holds each id, the others add zeros)
    is exact; the MLP is within bf16's 2e-2 of the reference's (whose
    bf16 activation rounds in its own order) and equals, bit for bit, the
    ranks' fp32 partials summed in fp32 and cast once, which the ranks'
    tp=1 outputs (each rounded to bf16 first) summed do not."""
    tp, d, f, vocab = 2, 32, 64, 40
    rng = np.random.default_rng(11)
    bf = jnp.bfloat16
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    w_up = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    w_gate = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    w_down = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    ids = rng.integers(0, vocab, (2, 8)).astype(np.int32)
    kw = dict(name="t", d_model=d, n_heads=2, n_kv_heads=2, head_dim=16,
              d_ff=f, vocab_size=vocab)
    jcfg, cfg = JaxBase(**kw), BaseConfig(**kw)

    def run(_):
        rank = jax.lax.axis_index("model")
        jctx = _ctx(tp)
        sl = jax.lax.dynamic_slice_in_dim
        tl = {"table": sl(jnp.asarray(table, bf), rank * (vocab // tp),
                          vocab // tp, 0)}
        emb = JL.embed_lookup(tl, jnp.asarray(ids), vocab, jctx)
        p = {"w_up": sl(jnp.asarray(w_up, bf), rank * (f // tp), f // tp, 1),
             "w_gate": sl(jnp.asarray(w_gate, bf), rank * (f // tp),
                          f // tp, 1),
             "w_down": sl(jnp.asarray(w_down, bf), rank * (f // tp),
                          f // tp, 0)}
        return emb, JL.mlp_fwd(p, jnp.asarray(x, bf), jcfg, jctx)

    emb, y = _smap(run, tp, (P(), P()))(jnp.zeros(()))
    ctx = L.AxisCtx(tp=tp)

    def bft(a):
        return _t(a).to(torch.bfloat16)

    got_emb = L.embed_lookup(
        {"table": Ranks(bft(a) for a in _rank_slices(table, vocab // tp, 0,
                                                     tp))},
        _t(ids).long(), vocab, ctx)
    assert got_emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_emb.float().numpy(),
                                  np.asarray(emb, np.float32))
    p = {k: Ranks(bft(a) for a in _rank_slices(w, f // tp, ax, tp))
         for k, w, ax in (("w_up", w_up, 1), ("w_gate", w_gate, 1),
                          ("w_down", w_down, 0))}
    got = L.mlp_fwd(p, bft(x), cfg, ctx)
    assert got.dtype == torch.bfloat16
    want = np.asarray(y, np.float32)
    _close(got, want, tol=2e-2)
    # the ranks' fp32 partials, summed in fp32 and cast once
    parts = [L.mlp_fwd(TP.rank_view(p, r), bft(x), cfg, L.AxisCtx())
             for r in range(tp)]
    fp32_parts = []
    for r in range(tp):
        pr = TP.rank_view(p, r)
        h = F.silu(L.matmul(bft(x), pr["w_gate"])) * L.matmul(bft(x),
                                                               pr["w_up"])
        fp32_parts.append(L.matmul(h, pr["w_down"], torch.float32))
    once = (fp32_parts[0] + fp32_parts[1]).to(torch.bfloat16)
    assert torch.equal(got, once)
    # rounding each rank's partial first (the tp=1 shortcut, per rank)
    # gives other numbers
    per_rank = parts[0] + parts[1]
    assert not torch.equal(got, per_rank)


FAMILIES = ["qwen3-0.6b", "qwen2.5-3b", "gpt2-paper-1b", "deepseek-7b",
            "nemotron-4-340b", "mixtral-8x7b", "deepseek-v2-lite-16b",
            "whisper-large-v3", "phi-3-vision-4.2b", "zamba2-1.2b",
            "xlstm-1.3b"]


def _axes_equal(got, want):
    g = [(p, a) for p, a in flatten_with_paths(got)]
    w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda v: v is None)[0]
    w = [(tuple(k.key for k in path), a) for path, a in w]
    assert g == w


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_axes_split_and_infer_match_the_reference(arch, tp):
    """Every family's smoke ``tp_axes`` at tp = 2 and 4 equal the
    reference's integers; ``infer_tp_axes`` from the tp=1 and tp=N param
    shapes gives the reference's answer; ``split_for_tp`` of one global
    tree (the stem, and one layer of each group) gives the reference's
    shards rank by rank, at the model's own tp-local shapes.  Where the
    port's axis carries a split rule (``tp.TPAxis``), the reference's
    split is taken where the rule puts the axis: ``lead`` stacked
    sub-layer axes further in (zamba's mamba layers, xlstm's mLSTMs in a
    unit, whose axes the reference counts from the sub-layer), and for a
    head-major axis (mLSTM's value channels) of the tree with each head's
    columns regrouped rank-major, so that the reference's contiguous
    split takes every head's slice of a rank."""
    jcfg = jax_config(arch, smoke=True).replace(param_dtype="float32",
                                                compute_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32",
                                               compute_dtype="float32")
    jm = jax_model_class(jcfg)(jcfg, _ctx(tp))
    m = model_class(cfg)(cfg, L.AxisCtx(tp=tp))
    axes = m.tp_axes()
    _axes_equal(axes, jm.tp_axes())
    one = model_class(cfg)(cfg, L.AxisCtx())
    g_specs, l_specs = one.param_specs(), m.param_specs()
    jg = jax_model_class(jcfg)(jcfg, JL.AxisCtx()).param_specs()
    jl = jm.param_specs()
    for part in ["stem"] + [("groups", g.name) for g in m.groups()]:
        if part == "stem":
            gs, ls, jgs, jls, ax = (g_specs["stem"], l_specs["stem"],
                                    jg["stem"], jl["stem"], axes["stem"])
        else:
            name = part[1]
            gs, ls = g_specs["groups"][name], l_specs["groups"][name]
            jgs, jls = jg["groups"][name], jl["groups"][name]
            ax = axes["groups"][name]
        _axes_equal(TP.infer_tp_axes(gs, ls, tp),
                    jtp.infer_tp_axes(jgs, jls, tp))
    params = one.init_params(torch.Generator().manual_seed(0))
    for name, tree, ax in [("stem", params["stem"], axes["stem"])] + [
            (g.name, {k: v for k, v in _first(params["groups"][g.name])
                      .items()}, axes["groups"][g.name])
            for g in m.groups()]:
        jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                             tree)
        jax_axes = (jm.tp_axes()["stem"] if name == "stem"
                    else jm.tp_axes()["groups"][name])
        want_shapes = (l_specs["stem"] if name == "stem"
                       else _first(l_specs["groups"][name]))
        for r in range(tp):
            got = TP.split_for_tp(tree, ax, tp, r)
            want = _reference_split(jtree, jax_axes, ax, tp, r)
            wl = jax.tree_util.tree_leaves(want)
            gl = [t for _, t in flatten_with_paths(got)]
            sl = [t for _, t in flatten_with_paths(want_shapes)]
            assert len(gl) == len(wl) == len(sl)
            for a, b, s in zip(gl, wl, sl):
                assert tuple(a.shape) == tuple(s.shape)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _reference_split(jtree, jax_axes, axes, tp, rank):
    """The reference's ``split_for_tp`` of ``jtree`` at the axis and in
    the column order that the port's split rule (``axes``) gives each
    leaf (the test's docstring)."""
    def leaf(t, jax_ax, ax):
        if ax is None:
            return jtp.split_for_tp(t, jax_ax, tp, rank)
        at = int(ax) + getattr(ax, "lead", 0)
        heads = getattr(ax, "heads", None)
        if heads:
            shape = t.shape
            t = t.reshape(shape[:at] + (heads, tp, -1) + shape[at + 1:])
            t = jnp.swapaxes(t, at, at + 1).reshape(shape)
        return jtp.split_for_tp(t, at, tp, rank)

    flat = flatten_with_paths(axes)
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    ja = jax.tree_util.tree_leaves(jax_axes, is_leaf=lambda v: v is None)
    out = [leaf(t, a, ax) for (_, t), a, (_, ax) in zip(jl, ja, flat)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jtree),
                                        out)


def _first(stacked):
    """Layer 0 of a group's stacked ``[L, ...]`` tree."""
    if isinstance(stacked, dict):
        return {k: _first(v) for k, v in stacked.items()}
    return stacked[0]


def test_split_pads_a_vocab_tp_does_not_divide():
    """``split_for_tp`` gives every rank ``ceil(vocab / tp)`` rows, the
    last rank's past the vocab zero (``init_embedding``'s shape), and
    ``infer_tp_axes`` reads that shape as axis 0."""
    t = torch.arange(510 * 3, dtype=torch.float32).reshape(510, 3)
    parts = [TP.split_for_tp({"table": t}, {"table": 0}, 4, r)["table"]
             for r in range(4)]
    assert [tuple(p.shape) for p in parts] == [(128, 3)] * 4
    assert torch.equal(torch.cat(parts)[:510], t)
    assert float(parts[3][-2:].abs().max()) == 0.0
    local = L.init_embedding(torch.Generator(), 510, 3, 4)
    assert TP.infer_tp_axes({"table": t}, local, 4) == {"table": 0}
