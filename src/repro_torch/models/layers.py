"""Dense model layers of the port (tp=1 subset of ``repro.models.layers``).

Conventions
-----------
* Layers are plain functions on tensors that take per-layer param dicts.
  On the serving path those dicts hold views into chunk payloads: the
  chunk is the storage, so the port has no ``nn.Parameter``s (they would
  duplicate it).
* Shapes, layouts and dtypes follow the reference at every public
  function ([B, S, H, D] attention, vocab-local logits in fp32), so the
  parity tests compare like with like.
* Products accumulate in fp32, as the reference's
  ``preferred_element_type=float32``.  Where the reference mixes dtypes
  (a bf16 activation times an fp32 chunk payload) JAX promotes to fp32;
  torch would refuse, so :func:`matmul` casts explicitly.
* Attention on a CUDA tensor always runs the hand-written kernel
  (:func:`repro_torch.kernels.ops.flash_attention`); on a CPU tensor
  :func:`attention_core` mirrors the reference's ``auto`` choice exactly.
* Only tensor parallelism 1 is ported, and no sliding window.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """The reference's mesh-axis context, reduced to one device."""

    tp: int = 1
    attn_impl: str = "auto"  # "naive" | "scan" | "auto" (CPU tensors only)
    attn_block: int = 512  # kv block of the scan implementation


def _no_window(cfg) -> None:
    if getattr(cfg, "sliding_window", None):
        raise NotImplementedError(
            "sliding-window attention is not ported yet")


# ---------------------------------------------------------------------------
# initializers / numerics helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32):
    std = 1.0 / math.sqrt(max(shape[in_axis], 1))
    return (torch.randn(shape, generator=gen) * std).to(dtype)


def matmul(x, w, ctx_dtype=None):
    """``x @ w`` accumulated in fp32, returned in ``ctx_dtype`` (default
    ``x.dtype``).  Same-dtype operands run natively (fp32 accumulate);
    mixed operands promote to fp32 first, as JAX does."""
    out = ctx_dtype or x.dtype
    if x.dtype == w.dtype == out:
        return x @ w
    return (x.float() @ w.float()).to(out)


def rms_norm(x, weight, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def squared_relu(x):
    r = torch.relu(x)
    return r * r


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": squared_relu,
    "relu": torch.relu,
}


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim//2]


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores (pure math on [B, S, H, Dh] tensors)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _visible(sq, sk, device, *, causal, window, q_offset, kv_len):
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    return mask


def naive_attention(q, k, v, *, causal: bool, window: int | None = None,
                    q_offset: int = 0, kv_len: int | None = None,
                    scale: float | None = None):
    """Reference attention. q: [B,Sq,H,D], k/v: [B,Sk,KV,D] (KV divides H).
    Probabilities are rounded to ``q.dtype`` before the PV product, as in
    the reference."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _visible(sq, sk, q.device, causal=causal, window=window,
                    q_offset=q_offset, kv_len=kv_len)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


def scan_attention(q, k, v, *, causal: bool, window: int | None = None,
                   q_offset: int = 0, kv_len: int | None = None,
                   scale: float | None = None, block: int = 512):
    """Online-softmax (flash-style) attention as a loop over KV blocks,
    probabilities kept in fp32 — the reference's scan twin."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // kvh
    nblk = -(-sk // block)
    pad = nblk * block - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = torch.arange(sq, device=q.device) + q_offset
    q32 = q.float() * scale
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        kblk = k[:, i * block:(i + 1) * block]
        vblk = v[:, i * block:(i + 1) * block]
        if rep != 1:
            kblk = kblk.repeat_interleave(rep, dim=2)
            vblk = vblk.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, kblk.float())
        kpos = i * block + torch.arange(block, device=q.device)
        mask = kpos[None, :] < (sk if kv_len is None else kv_len)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > (qpos[:, None] - window))
        logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vblk.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention_core(q, k, v, ctx: AxisCtx, **kw):
    """The kernel for a CUDA tensor; on the CPU the reference's choice."""
    if q.device.type == "cuda":
        return ops.flash_attention(q, k, v, **kw)
    impl = ctx.attn_impl
    if impl == "auto":
        impl = "scan" if (k.shape[1] > 2048 or q.shape[1] > 2048) else "naive"
    if impl == "scan":
        return scan_attention(q, k, v, block=ctx.attn_block, **kw)
    return naive_attention(q, k, v, **kw)


# ---------------------------------------------------------------------------
# GQA attention block (tp=1)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    """cfg needs: d_model, n_heads, n_kv_heads, head_dim, qk_norm, qkv_bias."""
    if tp != 1:
        raise NotImplementedError("only tp=1 is ported")
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype=dtype),
        "wk": dense_init(gen, (d, kv * hd), dtype=dtype),
        "wv": dense_init(gen, (d, kv * hd), dtype=dtype),
        "wo": dense_init(gen, (h * hd, d), dtype=dtype),
    }
    if getattr(cfg, "qkv_bias", False):
        p["bq"] = torch.zeros((h * hd,), dtype=dtype)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype)
    if getattr(cfg, "qk_norm", False):
        p["q_norm"] = torch.ones((hd,), dtype=dtype)
        p["k_norm"] = torch.ones((hd,), dtype=dtype)
    return p


def _project_qkv(p, x, cfg, ctx: AxisCtx, positions):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = matmul(x, p["wq"])
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if getattr(cfg, "use_rope", True):
        theta = getattr(cfg, "rope_theta", 10000.0)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _positions(b, s, device):
    return torch.arange(s, device=device).expand(b, s)


def attention_fwd(p, x, cfg, ctx: AxisCtx, *, positions=None, causal=True):
    """Full-sequence attention (training / prefill). x: [B, S, d]."""
    _no_window(cfg)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    q, k, v = _project_qkv(p, x, cfg, ctx, positions)
    out = attention_core(q, k, v, ctx, causal=causal)
    y = matmul(out.reshape(b, s, -1), p["wo"], torch.float32)
    return y.to(x.dtype)


def attention_prefill(p, x, cfg, ctx: AxisCtx, *, positions=None):
    """Prefill returning output and the KV cache."""
    _no_window(cfg)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    q, k, v = _project_qkv(p, x, cfg, ctx, positions)
    out = attention_core(q, k, v, ctx, causal=True, q_offset=0)
    y = matmul(out.reshape(b, s, -1), p["wo"], torch.float32)
    return y.to(x.dtype), _prefill_cache(k, v, s, cfg, ctx)


def _prefill_cache(k, v, s, cfg, ctx: AxisCtx):
    """The freshly computed K/V in the cache layout ("tp" mode, tp=1)."""
    return {"k": k, "v": v}


def decode_cache_plan(cfg, tp: int):
    """How the decode KV cache distributes over the model axis: with
    tp=1, the reference's "tp" mode (every kv head, full sequence)."""
    if tp != 1:
        raise NotImplementedError("only tp=1 is ported")
    return "tp", cfg.n_kv_heads, 1


def attention_init_cache(cfg, batch: int, max_len: int, tp: int, dtype,
                         device=None) -> dict:
    _no_window(cfg)
    _, kv_l, _ = decode_cache_plan(cfg, tp)
    shape = (batch, max_len, kv_l, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, x, cache, pos: int, cfg, ctx: AxisCtx):
    """Single-token decode. x: [B, 1, d]; pos: the int position written;
    cache k/v: [B, C, KV, hd].  Returns the output and a new cache (the
    inputs are not modified)."""
    _no_window(cfg)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, ctx, positions)
    ck = cache["k"].clone()
    cv = cache["v"].clone()
    ck[:, pos:pos + 1] = k.to(ck.dtype)
    cv[:, pos:pos + 1] = v.to(cv.dtype)
    out = _decode_attend(q, ck, cv, pos)
    y = matmul(out.reshape(b, 1, -1), p["wo"], torch.float32)
    return y.to(x.dtype), {"k": ck, "v": cv}


def _decode_attend(q, k, v, pos: int):
    """q: [B,1,H,D]; k/v: [B,C,KV,D]; cache slots ``<= pos`` are valid.
    On a CUDA tensor the kernel stops at ``kv_len = pos + 1``; on the CPU
    this is the reference's masked softmax, probabilities rounded to
    ``q.dtype``."""
    if q.device.type == "cuda":
        return ops.flash_attention(q, k, v, causal=True, q_offset=pos,
                                   kv_len=pos + 1)
    h, d = q.shape[2], q.shape[3]
    if k.shape[2] != h:
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(d)
    valid = torch.arange(k.shape[1], device=q.device) < pos + 1
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP (gated / plain)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg, tp: int = 1, dtype=torch.float32) -> dict:
    if tp != 1:
        raise NotImplementedError("only tp=1 is ported")
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": dense_init(gen, (d, f), dtype=dtype),
         "w_down": dense_init(gen, (f, d), dtype=dtype)}
    if getattr(cfg, "gated_mlp", True):
        p["w_gate"] = dense_init(gen, (d, f), dtype=dtype)
    return p


def mlp_fwd(p, x, cfg, ctx: AxisCtx):
    act = ACTIVATIONS[getattr(cfg, "activation", "silu")]
    up = matmul(x, p["w_up"])
    if "w_gate" in p:
        h = act(matmul(x, p["w_gate"])) * up
    else:
        h = act(up)
    return matmul(h, p["w_down"], torch.float32).to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / head / greedy sampling
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d_model: int, tp: int = 1,
                   dtype=torch.float32) -> dict:
    if tp != 1:
        raise NotImplementedError("only tp=1 is ported")
    return {"table": dense_init(gen, (vocab, d_model), in_axis=1,
                                dtype=dtype)}


def embed_lookup(p, ids, vocab: int, ctx: AxisCtx):
    """Token embedding (tp=1: the whole vocab is local)."""
    return p["table"][ids]


def lm_logits_local(p, x, ctx: AxisCtx):
    """Tied head: x @ table^T -> fp32 logits over the (local) vocab."""
    return x.float() @ p["table"].float().T


def greedy_token(local_logits, vocab: int, ctx: AxisCtx):
    """Argmax over the vocab of [B,1,V] logits -> [B] int64 token ids.

    Ties break toward the lowest token id by an explicit rule (the
    reference's), not by whatever a backend's argmax does; ids at or past
    ``vocab`` (padding rows) never win."""
    vl = local_logits.shape[-1]
    gid = torch.arange(vl, device=local_logits.device)
    ll = torch.where(gid < vocab, local_logits, -torch.inf)
    lmax = ll.amax(dim=-1, keepdim=True)
    cand = torch.where(ll >= lmax, gid, vocab + 1)
    return cand.amin(dim=-1)[..., 0]
