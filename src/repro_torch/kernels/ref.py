"""Plain PyTorch versions of the port's kernels: the path a CPU tensor
takes, and the oracle every hand-written kernel is held against on the
card."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # the reference's mask value


def _visible(sq, sk, device, *, causal, q_offset, kv_len, window,
             kv_lens=None):
    """[Sq, Sk] mask: query i at position ``q_offset + i`` sees key j; with
    ``kv_lens`` ([B] on ``device``), [B, 1, Sq, Sk]: row b's keys also
    stop at ``kv_lens[b]``."""
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    mask = kpos[None, :] < (sk if kv_len is None else kv_len)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    if kv_lens is not None:
        mask = mask & (kpos < kv_lens.reshape(-1, 1, 1, 1))
    return mask


def _repeat_kv(t, h):
    """[B,S,KV,D] -> [B,S,H,D] fp32, query head h reading kv head
    h // (H // KV)."""
    t = t.float()
    return t if t.shape[2] == h else t.repeat_interleave(h // t.shape[2], 2)


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        kv_len: int | None = None, kv_lens=None,
                        window: int | None = None,
                        scale: float | None = None, return_lse: bool = False,
                        matmul=torch.matmul):
    """Masked-softmax attention with fp32 scores and probabilities — the
    function K2 computes.  q: [B,Sq,H,D]; k: [B,Sk,KV,D]; v: [B,Sk,KV,Dv]
    (Dv may differ from D, as MLA's does; out is [B,Sq,H,Dv]) with KV | H
    (query head h reads kv head h // (H // KV)).  Query i sits at position
    ``q_offset + i``; key j is visible iff ``j < kv_len`` and, when set,
    ``j <= q_offset + i`` (causal), ``j > q_offset + i - window`` and, for
    batch row b, ``j < kv_lens[b]`` (``kv_lens``: [B] integers on q's
    device, each >= 1: one length a row, as the compiled serving round's
    slots decode from their own positions).
    ``return_lse`` also returns the fp32 log-sum-exp of the scaled
    scores, [B,H,Sq] — what K2 saves for its backward.  ``matmul`` forms
    the two products, S = Q K^T (scaled after it) and P V, on fp32
    [B,H,rows,cols] operands: ``tf32_matmul`` makes this the model of the
    fp32 forward kernel's split-TF32 arithmetic."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qh = q.float().transpose(1, 2)  # [B,H,Sq,D]
    kh, vh = (_repeat_kv(t, h).transpose(1, 2) for t in (k, v))
    logits = matmul(qh, kh.transpose(-1, -2)) * scale
    mask = _visible(sq, sk, q.device, causal=causal, q_offset=q_offset,
                    kv_len=kv_len, window=window, kv_lens=kv_lens)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = matmul(probs, vh).transpose(1, 2).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_attention_splitkv_ref(q, k, v, *, splits: int, split_lo: int,
                                split_rows: int, causal: bool = True,
                                q_offset: int = 0, kv_len: int | None = None,
                                kv_lens=None, window: int | None = None,
                                scale: float | None = None,
                                return_lse: bool = False):
    """:func:`flash_attention_ref` computed the way K2's split-kv
    schedule computes it: split s covers kv rows ``[split_lo + s *
    split_rows, + split_rows)``; each split keeps its own fp32 (m, l, acc)
    over the keys it can see, and the splits are merged with weights
    ``exp(m_s - M)``.  A split with no visible key has m = -1e30 and l = 0
    and weighs exactly 0 (no NaN: -1e30 - -1e30 is 0); with per-row
    ``kv_lens`` and splits over the whole horizon, most splits of a short
    row are such.  The oracle the card's combine kernel is held against."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          _repeat_kv(k, h)) * scale
    mask = _visible(sq, sk, q.device, causal=causal, q_offset=q_offset,
                    kv_len=kv_len, window=window, kv_lens=kv_lens)
    vr = _repeat_kv(v, h)
    kpos = torch.arange(sk, device=q.device)
    ms, ls, accs = [], [], []
    for s in range(splits):
        lo = split_lo + s * split_rows
        seen = mask & ((kpos >= lo) & (kpos < lo + split_rows))[None, :]
        x = torch.where(seen, logits, NEG_INF)
        m = x.amax(dim=-1)  # -1e30 where the split sees nothing
        p = torch.where(seen, torch.exp(x - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhqk,bkhd->bhqd", p, vr))
    big = torch.stack(ms).amax(dim=0)
    w = [torch.exp(m - big) for m in ms]
    total = sum(li * wi for li, wi in zip(ls, w))
    acc = sum(a * wi[..., None] for a, wi in zip(accs, w))
    total = torch.clamp(total, min=1e-30)
    out = (acc / total[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, big + torch.log(total)
    return out


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            q_offset: int = 0, kv_len: int | None = None,
                            window: int | None = None,
                            scale: float | None = None,
                            matmul=torch.matmul):
    """The gradients of :func:`flash_attention_ref` — the function K2's
    backward computes — from the explicit formulas, in fp32:

        P  = exp(S * scale - lse)       (0 where masked)
        dV = P^T dO
        dP = dO V^T,  delta = rowsum(dO * O)
        dS = P * (dP - delta)
        dQ = dS K * scale,  dK = dS^T Q * scale

    o and lse are the forward's output and log-sum-exp ([B,H,Sq] fp32);
    o, do and dv have v's head dim Dv, which may differ from D (MLA).
    GQA is native: dk and dv sum over the query heads that read each kv
    head.  ``matmul`` forms the five products, on fp32 [B,H,rows,cols]
    operands: ``tf32_matmul`` makes this the model of the fp32 backward
    kernel's split-TF32 arithmetic.  Returns (dq, dk, dv) in the dtypes of
    q, k and v."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, doh = (t.float().transpose(1, 2) for t in (q, do))  # [B,H,Sq,D]
    kh, vh = (_repeat_kv(t, h).transpose(1, 2) for t in (k, v))
    mask = _visible(sq, sk, q.device, causal=causal, q_offset=q_offset,
                    kv_len=kv_len, window=window)
    s = matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dv = matmul(p.transpose(-1, -2), doh).transpose(1, 2)
    dp = matmul(doh, vh.transpose(-1, -2))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B,H,Sq]
    ds = p * (dp - delta[..., None])
    dq = (matmul(ds, kh) * scale).transpose(1, 2)
    dk = (matmul(ds.transpose(-1, -2), qh) * scale).transpose(1, 2)
    if kvh != h:
        dk = dk.reshape(b, sk, kvh, h // kvh, d).sum(3)
        dv = dv.reshape(b, sk, kvh, h // kvh, v.shape[3]).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_round(x):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: ``cvt.rna.tf32.f32`` on the card.  Finite inputs."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a, b, *, terms: int = 3):
    """``a @ b`` in fp32 as the tensor cores form it from TF32 operands.
    ``terms=3``: the split product of the fp32 ``tf32x3`` schedule,
    ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` with ``hi = tf32_round(x)`` and
    ``lo = tf32_round(x - hi)``, the small terms first; ``terms=1``: one
    TF32 product, ``a_hi b_hi``.  As the ``matmul`` of
    :func:`flash_attention_ref` and :func:`flash_attention_bwd_ref`, the
    model of the fp32 forward and backward kernels."""
    ah, bh = tf32_round(a), tf32_round(b)
    if terms == 1:
        return ah @ bh
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def adam_ref(p32, m, v, g, *, lr, beta1, beta2, eps, weight_decay,
             bias_corr1, bias_corr2):
    """Fused chunked-ADAM — the function K1 computes (the reference's
    ``repro.kernels.ref.adam_ref``).  All fp32, any shape; g may be bf16.
    Returns new (p32', m', v'); the inputs are not modified."""
    g32 = g.float()
    m = beta1 * m + (1.0 - beta1) * g32
    v = beta2 * v + (1.0 - beta2) * g32 * g32
    mhat = m / bias_corr1
    vhat = v / bias_corr2
    upd = mhat / (torch.sqrt(vhat) + eps)
    if weight_decay:
        upd = upd + weight_decay * p32
    p32 = p32 - lr * upd
    return p32, m, v
