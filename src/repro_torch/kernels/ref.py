"""Plain PyTorch versions of the port's kernels: the path a CPU tensor
takes, and the oracle every CUDA kernel is held against on the card."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # the reference's mask value


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        kv_len: int | None = None, window: int | None = None,
                        scale: float | None = None):
    """Masked-softmax attention with fp32 scores and probabilities — the
    function K2 computes.  q: [B,Sq,H,D]; k/v: [B,Sk,KV,D] with KV | H
    (query head h reads kv head h // (H // KV)).  Query i sits at position
    ``q_offset + i``; key j is visible iff ``j < kv_len`` and, when set,
    ``j <= q_offset + i`` (causal) and ``j > q_offset + i - window``."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k32, v32 = k.float(), v.float()
    if kvh != h:
        k32 = k32.repeat_interleave(h // kvh, dim=2)
        v32 = v32.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k32) * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = kpos[None, :] < (sk if kv_len is None else kv_len)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v32).to(q.dtype)
