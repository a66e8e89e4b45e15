"""Public kernel entry points of the port: the hand-written kernel for a
CUDA tensor, its plain PyTorch version for a CPU tensor, and for a meta
tensor the kernel's outputs as shapes only — a CUDA tensor never reaches
the plain version, a CPU tensor never reaches the shape-only branch, and
a failed build or launch raises.

The meta branch is what the dry-run (:mod:`repro_torch.launch.dryrun`)
traces: it writes nothing, returns empty tensors of the kernel's shapes
and dtypes (K2's forward its output and log-sum-exp, its backward dQ, dK
and dV), and adds one call and the kernel's work (:func:`~repro_torch.
kernels.flash_attention.forward_work`, :func:`~repro_torch.kernels.
flash_attention.backward_work`, :func:`~repro_torch.kernels.chunked_adam.
work`: the counts ``chip_smoke.py``'s bound column uses) to the
:class:`KernelWork` that :func:`counting` made active, if any."""

from __future__ import annotations

import collections
import contextlib

import torch

from repro_torch.kernels import chunked_adam as _adam
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.ref import adam_ref, flash_attention_ref


class KernelWork:
    """The kernel calls of a meta trace: ``calls`` by name (``k2_fwd``,
    ``k2_bwd``, ``k1``), ``work`` their summed ``flops`` and ``bytes`` by
    name, and the totals."""

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()
        self.work: dict = {}

    def add(self, name: str, work: dict) -> None:
        self.calls[name] += 1
        w = self.work.setdefault(name, {"flops": 0.0, "bytes": 0.0})
        w["flops"] += work["flops"]
        w["bytes"] += work["bytes"]

    @property
    def flops(self) -> float:
        return sum(w["flops"] for w in self.work.values())

    @property
    def bytes(self) -> float:
        return sum(w["bytes"] for w in self.work.values())


_active: KernelWork | None = None


@contextlib.contextmanager
def counting():
    """Count the meta branch's kernel calls and work inside the block:
    yields the :class:`KernelWork` they add to."""
    global _active
    prev, _active = _active, KernelWork()
    try:
        yield _active
    finally:
        _active = prev


def _record(name: str, work: dict) -> None:
    if _active is not None:
        _active.add(name, work)


def _device_of(t) -> str:
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


class _MetaAttention(torch.autograd.Function):
    """K2 on meta tensors: the forward's output and lse (saved, as the
    card's forward saves them), the backward's dQ, dK and dV, as empty
    tensors of the kernels' shapes and dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None):
        b, sq, h, d = q.shape
        sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
        _record("k2_fwd", _fa.forward_work(
            b, sq, sk, h, kv, d, dv, q.element_size(), causal=causal,
            window=window))
        out = q.new_empty((b, sq, h, dv))
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, _, _ = ctx.saved_tensors
        b, s, h, d = q.shape
        _record("k2_bwd", _fa.backward_work(
            b, s, h, k.shape[2], d, v.shape[3], q.element_size(),
            causal=ctx.causal, window=ctx.window, sk=k.shape[1]))
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None, None)


def _meta_attention(q, k, v, *, causal, q_offset, kv_len, kv_lens, window):
    """The meta branch of :func:`flash_attention`: differentiable where
    the card's is (:class:`_MetaAttention`); per-row ``kv_lens`` hold no
    values here, so each row counts its whole ``kv_len``."""
    window = None if window is None else int(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _MetaAttention.apply(q, k, v, bool(causal), window)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _record("k2_fwd", _fa.forward_work(
        b, sq, sk, h, k.shape[2], d, v.shape[3], q.element_size(),
        causal=bool(causal) and kv_lens is None, q_offset=int(q_offset),
        kv_len=None if kv_len is None else int(kv_len), window=window))
    return q.new_empty((b, sq, h, v.shape[3]))


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: int | None = None, kv_lens=None,
                    window: int | None = None, scale: float | None = None):
    """[B,Sq,H,D] x [B,Sk,KV,D] x [B,Sk,KV,Dv] -> [B,Sq,H,Dv] attention (see
    :func:`~repro_torch.kernels.ref.flash_attention_ref`), differentiable:
    on a CUDA tensor K2 and its backward kernel
    (:func:`repro_torch.kernels.flash_attention.attention`), on a CPU
    tensor the plain version, which autograd differentiates, on a meta
    tensor the kernels' shapes (module docstring).  ``kv_lens`` (int32
    [B] on q's device) bounds each row's keys on top of the other masks
    (on the card: decode only)."""
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              kv_lens=kv_lens, window=window)
    dev = _device_of(q)
    if dev == "cuda":
        return _fa.attention(q, k, v, scale=scale, **kw)
    if dev == "meta":
        return _meta_attention(q, k, v, **kw)
    return flash_attention_ref(q, k, v, scale=scale, **kw)


def chunked_adam(p32, m, v, g, *, out, lr, beta1, beta2, eps, weight_decay,
                 bias_corr1, bias_corr2) -> None:
    """Fused ADAM over flat chunk payloads, in place: p32, m and v (fp32)
    take their updated values, and ``out`` (fp32 or bf16, and it may be
    ``g`` itself) the updated params cast to its dtype.  On a
    CUDA tensor K1 (:mod:`repro_torch.kernels.chunked_adam`), on a CPU
    tensor the plain version (:func:`~repro_torch.kernels.ref.adam_ref`),
    on a meta tensor nothing is written and the call is counted (module
    docstring)."""
    hp = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, bias_corr1=bias_corr1,
              bias_corr2=bias_corr2)
    dev = _device_of(p32)
    if dev == "cuda":
        _adam.chunked_adam_triton(p32, m, v, g, out, **hp)
        return
    if dev == "meta":
        _record("k1", _adam.work(p32.numel(), g.element_size(),
                                 out.element_size()))
        return
    p_new, m_new, v_new = adam_ref(p32, m, v, g, **hp)
    p32.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    out.copy_(p_new)

