"""Multi-head Latent Attention of the port (``repro.models.mla`` twin):
DeepSeek-V2's attention (arXiv:2405.04434).

KV is compressed into a per-token latent ``c`` of ``kv_lora_rank`` dims
plus one RoPE key ``k_pe`` of ``qk_rope_dim`` dims shared by the heads;
per-head keys and values are up-projections of the latent.

* Training and prefill (:func:`mla_fwd`) materialise per-head K and V and
  run attention with q/k head dim ``qk_nope_dim + qk_rope_dim`` (192 in
  deepseek-v2-lite) and value head dim ``v_head_dim`` (128): on a CUDA
  tensor K2 at that pair, forward and backward
  (:func:`repro_torch.models.layers.attention_core`); ``k_pe``'s gradient
  sums over the heads through autograd.
* Decode (:func:`mla_decode`) is the *absorbed* formulation: the query is
  mapped into latent space (``q_nope @ W_uk``), scored against the
  compressed cache ``[B, S, kv_lora + rope]`` and the attended latent is
  mapped out through ``W_uv``.  The reference computes it outside any
  Pallas kernel, and so does the port: matrix products in plain torch,
  accumulated in fp32, each operand first rounded to the dtype the
  reference rounds it to.

Tensor parallelism (the reference's): heads shard over the model axis
(wq, w_uk, w_uv, wo), the latent projections (w_dkv, w_krope, kv_norm)
are replicated, so the latent is computed once; each rank attends over
its own heads (K2 a rank) and the out projections psum.  The latent cache
is head-independent, so it shards by SEQUENCE: rank r keeps the strided
slots r, r + tp, ... (``ceil(S / tp)`` of them); the absorbed decode
gathers every head's latent query on every rank, scores it against the
rank's chunk, and combines the ranks' partial softmaxes with an
exp-weighted psum before each rank projects its own heads.  At tp=1 this
is the whole cache on one rank.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import AxisCtx
from repro_torch.models.tp import rank_view, ranks_tree


def _mla_dims(cfg, tp: int):
    if cfg.n_heads % tp != 0:
        raise ValueError(f"MLA heads {cfg.n_heads} % tp {tp} != 0")
    return cfg.n_heads // tp, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim


def init_mla(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    d, r = cfg.d_model, cfg.kv_lora_rank
    h, nope, rope, vd = _mla_dims(cfg, tp)
    return {
        "wq": L.dense_init(gen, (d, h * (nope + rope)), dtype=dtype),
        "w_dkv": L.dense_init(gen, (d, r), dtype=dtype),
        "w_krope": L.dense_init(gen, (d, rope), dtype=dtype),
        "kv_norm": torch.ones((r,), dtype=dtype),
        "w_uk": L.dense_init(gen, (r, h * nope), dtype=dtype),
        "w_uv": L.dense_init(gen, (r, h * vd), dtype=dtype),
        "wo": L.dense_init(gen, (h * vd, d), dtype=dtype),
    }


def mla_tp_axes() -> dict:
    """Which axis of each MLA param the model axis shards: heads (wq, w_uk,
    w_uv, wo); the latent projections are replicated."""
    return {"wq": 1, "w_dkv": None, "w_krope": None, "kv_norm": None,
            "w_uk": 1, "w_uv": 1, "wo": 0}


def _theta(cfg) -> float:
    return getattr(cfg, "rope_theta", 10000.0)


def _latent(p, x, cfg, positions):
    """-> (c [B,S,r] normed, k_pe [B,S,1,rope] roped), in x's dtype."""
    c = L.rms_norm(L.matmul(x, p["w_dkv"]), p["kv_norm"])
    k_pe = L.matmul(x, p["w_krope"])[:, :, None, :]
    return c, L.apply_rope(k_pe, positions, _theta(cfg))


def _queries(p, x, cfg, ctx: AxisCtx, positions):
    b, s, _ = x.shape
    h, nope, rope, _ = _mla_dims(cfg, ctx.tp)
    q = L.matmul(x, p["wq"]).reshape(b, s, h, nope + rope)
    return q[..., :nope], L.apply_rope(q[..., nope:], positions, _theta(cfg))


def _attend(p, x, cfg, ctx: AxisCtx, positions):
    """Full-sequence causal attention from per-head K/V materialised out of
    the latent, each rank over its own heads, then the out projections'
    psum: (y [B,S,d] in x's dtype, c, k_pe)."""
    b, s, _ = x.shape
    h, nope, rope, vd = _mla_dims(cfg, ctx.tp)
    c, k_pe = _latent(p, x, cfg, positions)
    out_dtype = x.dtype if ctx.tp == 1 else torch.float32
    ys = []
    for r in range(ctx.tp):
        pr = rank_view(p, r)
        q_nope, q_pe = _queries(pr, x, cfg, ctx, positions)
        k_nope = L.matmul(c, pr["w_uk"]).reshape(b, s, h, nope)
        v = L.matmul(c, pr["w_uv"]).reshape(b, s, h, vd)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, s, h, rope)], dim=-1)
        out = L.attention_core(q, k, v, ctx, causal=True,
                               scale=1.0 / math.sqrt(nope + rope))
        ys.append(L.matmul(out.reshape(b, s, -1), pr["wo"], out_dtype))
    return ctx.psum_model(ys).to(x.dtype), c, k_pe


def mla_fwd(p, x, cfg, ctx: AxisCtx, *, positions=None):
    """Training forward. x: [B, S, d]."""
    b, s, _ = x.shape
    if positions is None:
        positions = L._positions(b, s, x.device)
    return _attend(p, x, cfg, ctx, positions)[0]


def mla_init_cache(cfg, batch: int, max_len: int, dtype,
                   tp: int = 1, device=None) -> dict:
    """One rank's latent cache: ``c`` [B, ceil(S / tp), kv_lora_rank] and
    ``k_pe`` [B, ceil(S / tp), qk_rope_dim] (its strided sequence slots;
    tp=1: every slot)."""
    _mla_dims(cfg, tp)
    c_l = -(-max_len // tp)
    return {
        "c": torch.zeros((batch, c_l, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        "k_pe": torch.zeros((batch, c_l, cfg.qk_rope_dim), dtype=dtype,
                            device=device),
    }


def mla_prefill(p, x, cfg, ctx: AxisCtx):
    """Prefill returning the output and each rank's strided chunk of the
    prompt's latent cache (padded to whole chunks at tp > 1)."""
    b, s, _ = x.shape
    y, c, k_pe = _attend(p, x, cfg, ctx, L._positions(b, s, x.device))
    kp = k_pe[:, :, 0, :]
    tp = ctx.tp
    if tp == 1:
        return y, {"c": c, "k_pe": kp}
    pad = -(-s // tp) * tp - s
    if pad:
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
        kp = torch.nn.functional.pad(kp, (0, 0, 0, pad))
    return y, ranks_tree([{"c": c[:, r::tp].contiguous(),
                           "k_pe": kp[:, r::tp].contiguous()}
                          for r in range(tp)])


def mla_decode(p, x, cache, pos, cfg, ctx: AxisCtx):
    """Absorbed single-token decode against the latent cache. x: [B, 1, d].

    ``pos`` is either the int position every row writes — the eager
    engine's call, which returns a new cache (the inputs are not
    modified) — or, at tp=1, a [B] integer tensor on x's device, one
    position a row — the compiled round's slots: row b writes its latent
    at slot ``pos[b]`` of ``cache`` in place, attends to slots ``<=
    pos[b]`` and returns ``cache`` itself, with no device value read on
    the host, so a CUDA graph can capture it (as
    :func:`~repro_torch.models.layers.attention_decode` does).  At tp > 1
    (the eager decode only: the compiled round runs at tp=1) see
    :func:`_mla_decode_tp`."""
    if ctx.tp > 1:
        return _mla_decode_tp(p, x, cache, pos, cfg, ctx)
    b = x.shape[0]
    h, nope, rope, vd = _mla_dims(cfg, ctx.tp)
    r = cfg.kv_lora_rank
    per_row = isinstance(pos, torch.Tensor)
    positions = (pos[:, None] if per_row else
                 torch.full((b, 1), pos, dtype=torch.long, device=x.device))
    c_t, kpe_t = _latent(p, x, cfg, positions)  # [B,1,r], [B,1,1,rope]
    if per_row:
        rows = torch.arange(b, device=x.device)
        cache_c, cache_kpe = cache["c"], cache["k_pe"]
        cache_c.index_put_((rows, pos), c_t[:, 0].to(cache_c.dtype))
        cache_kpe.index_put_((rows, pos), kpe_t[:, 0, 0].to(cache_kpe.dtype))
    else:
        cache_c = cache["c"].clone()
        cache_kpe = cache["k_pe"].clone()
        cache_c[:, pos] = c_t[:, 0].to(cache_c.dtype)
        cache_kpe[:, pos] = kpe_t[:, 0, 0].to(cache_kpe.dtype)

    q_nope, q_pe = _queries(p, x, cfg, ctx, positions)  # [B,1,H,*]
    w_uk = p["w_uk"].float().reshape(r, h, nope)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk)
    cc = cache_c.float()
    scores = torch.einsum("bqhr,bsr->bhqs",
                          q_abs.to(cache_c.dtype).float(), cc)
    scores = scores + torch.einsum("bqhp,bsp->bhqs",
                                   q_pe.to(cache_kpe.dtype).float(),
                                   cache_kpe.float())
    scores = scores * (1.0 / math.sqrt(nope + rope))
    slot = torch.arange(cache_c.shape[1], device=x.device)
    seen = (slot[None, :] <= pos[:, None] if per_row
            else (slot <= pos)[None, :])  # [B or 1, S]
    scores = torch.where(seen[:, None, None, :], scores, L.NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    w = torch.exp(scores - m)
    l = w.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqs,bsr->bhqr", w.to(cache_c.dtype).float(), cc)
    latent = (acc / torch.clamp(l, min=1e-30)).permute(0, 2, 1, 3)
    w_uv = p["w_uv"].reshape(r, h, vd)
    out = torch.einsum("bqhr,rhv->bqhv", latent.to(w_uv.dtype).float(),
                       w_uv.float())
    y = L.matmul(out.reshape(b, 1, -1).to(x.dtype), p["wo"], x.dtype)
    return y, {"c": cache_c, "k_pe": cache_kpe}


def _mla_decode_tp(p, x, cache, pos, cfg, ctx: AxisCtx):
    """The reference's decode at tp > 1: the new latent into its owner's
    strided slot (rank ``pos % tp``), every head's absorbed query on every
    rank (the all-gather), each rank's partial softmax over its chunk,
    the exp-weighted psum across ranks, then each rank's own heads through
    its w_uv and wo slices and the out projections' psum."""
    if isinstance(pos, torch.Tensor):
        raise NotImplementedError(
            "per-row positions at tp > 1: the compiled serving round runs "
            "at tp=1, as the reference's")
    b = x.shape[0]
    h, nope, rope, vd = _mla_dims(cfg, ctx.tp)
    r_dim = cfg.kv_lora_rank
    tp = ctx.tp
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    c_t, kpe_t = _latent(p, x, cfg, positions)  # replicated: once
    caches, q_abs, q_pe = [], [], []
    for r in range(tp):
        cr = rank_view(cache, r)
        cache_c, cache_kpe = cr["c"].clone(), cr["k_pe"].clone()
        if pos % tp == r:
            cache_c[:, pos // tp] = c_t[:, 0].to(cache_c.dtype)
            cache_kpe[:, pos // tp] = kpe_t[:, 0, 0].to(cache_kpe.dtype)
        caches.append({"c": cache_c, "k_pe": cache_kpe})
        pr = rank_view(p, r)
        qn, qp = _queries(pr, x, cfg, ctx, positions)  # [B,1,h_l,*]
        w_uk = pr["w_uk"].float().reshape(r_dim, h, nope)
        q_abs.append(torch.einsum("bqhn,rhn->bqhr", qn.float(), w_uk))
        q_pe.append(qp)
    q_abs = ctx.all_gather(q_abs, dim=2)  # [B,1,H,r]
    q_pe = ctx.all_gather(q_pe, dim=2)
    ms, ls, accs = [], [], []
    for r, cr in enumerate(caches):
        cc = cr["c"].float()
        scores = torch.einsum("bqhr,bsr->bhqs",
                              q_abs.to(cr["c"].dtype).float(), cc)
        scores = scores + torch.einsum(
            "bqhp,bsp->bhqs", q_pe.to(cr["k_pe"].dtype).float(),
            cr["k_pe"].float())
        scores = scores * (1.0 / math.sqrt(nope + rope))
        gslot = torch.arange(cc.shape[1], device=x.device) * tp + r
        scores = torch.where((gslot <= pos)[None, None, None, :], scores,
                             L.NEG_INF)
        m = scores.amax(dim=-1)  # [B,H,1]
        w = torch.exp(scores - m[..., None])
        ls.append(w.sum(dim=-1))
        accs.append(torch.einsum("bhqs,bsr->bhqr",
                                 w.to(cr["c"].dtype).float(), cc))
        ms.append(m)
    m_star = ctx.pmax_model(ms)
    scales = [torch.exp(m - m_star) for m in ms]
    l_comb = ctx.psum_model([l * sc for l, sc in zip(ls, scales)])
    acc = ctx.psum_model([a * sc[..., None] for a, sc in zip(accs, scales)])
    latent = (acc / torch.clamp(l_comb[..., None], min=1e-30)).permute(
        0, 2, 1, 3)  # [B,1,H,r]
    ys = []
    for r in range(tp):
        pr = rank_view(p, r)
        w_uv = pr["w_uv"].reshape(r_dim, h, vd)
        mine = latent[:, :, r * h:(r + 1) * h]
        out = torch.einsum("bqhr,rhv->bqhv", mine.to(w_uv.dtype).float(),
                           w_uv.float())
        ys.append(L.matmul(out.reshape(b, 1, -1).to(x.dtype), pr["wo"],
                           torch.float32))
    return ctx.psum_model(ys).to(x.dtype), ranks_tree(caches)
