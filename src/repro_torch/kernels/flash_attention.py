"""K2 on Hopper: flash attention, forward and backward, as hand-written
CUDA kernels.

The forward replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_kernel``, ``pallas_call`` at line 92); its source is
``csrc/flash_attention.cu``.  The TPU package has no backward kernel (its
trainer differentiates the plain attention with XLA); the port's is
``csrc/flash_attention_bwd.cu``.  Each source's header states what the
kernel computes, its bound on an H100 and what the design does about it.
Both are built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`) and bound through a plain C interface
with ``ctypes``.

The wrappers check device, dtype, shape and contiguity and raise on
anything the kernels do not take, allocate outputs and scratch with
``torch.empty``, launch on the current stream, raise if a launch returns
a CUDA error, and count their launches:

* :func:`flash_attention_cuda` — the forward (:data:`launches`); with
  ``return_lse`` it also returns the fp32 log-sum-exp the backward needs;
* :func:`flash_attention_bwd_cuda` — the backward (:data:`bwd_launches`,
  one per call of its three kernels);
* :class:`FlashAttention` — the ``torch.autograd.Function`` joining them,
  and :func:`attention`, the entry the port's layers reach on a CUDA
  tensor: the autograd path when a gradient is asked for, the plain
  forward launch otherwise.

Their plain PyTorch versions are :data:`plain` and :data:`plain_bwd`
(:mod:`repro_torch.kernels.ref`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_bwd_ref as plain_bwd
from repro_torch.kernels.ref import flash_attention_ref as plain

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
REPLACES = "src/repro/kernels/flash_attention.py:92"
BWD_REPLACES = ("src/repro/kernels/flash_attention.py:92 (its gradient: the "
                "TPU package has no backward kernel and differentiates "
                "naive_attention, src/repro/models/layers.py:229, with XLA)")
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (plain counts, read by chip_smoke)
launches = 0
bwd_launches = 0
_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda",
           "FlashAttention", "attention", "plain", "plain_bwd", "launches",
           "bwd_launches", "load", "load_bwd"]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the forward kernel's library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.library(SOURCE)))
        lib.flash_attn_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.flash_attn_fwd.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def load_bwd() -> ctypes.CDLL:
    """Build (if needed) and load the backward kernels' library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = ctypes.CDLL(str(build.library(BWD_SOURCE)))
        lib.flash_attn_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attn_bwd.restype = ctypes.c_int
        lib.flash_attn_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"[B,S,heads,D], got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"contiguous")
        if t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v on different "
                             "devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: q/k/v must all be float32 "
                        f"or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match [B,Sq,H,D] x [B,Sk,KV,D]")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention_cuda: {k.shape[2]} kv heads do "
                         f"not divide {h} query heads")
    if min(b, sq, k.shape[1]) < 1 or max(b, sq, h, k.shape[1]) >= 2**31:
        raise ValueError("flash_attention_cuda: empty or oversized dims")


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0,
                         kv_len: int | None = None,
                         window: int | None = None,
                         scale: float | None = None,
                         return_lse: bool = False):
    """Launch K2: out [B,Sq,H,D] in q's dtype (see :data:`plain` for the
    function); with ``return_lse``, (out, lse [B,H,Sq] fp32)."""
    global launches
    _check(q, k, v)
    sk = k.shape[1]
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"flash_attention_cuda: kv_len {kv_len} outside "
                         f"[1, {sk}]")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"flash_attention_cuda: q_offset {q_offset} < 0")
    if window is not None and int(window) < 1:
        raise ValueError(f"flash_attention_cuda: window {window} < 1")
    b, sq, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, h, k.shape[2], d, q_offset, kv_len,
            int(bool(causal)), 0 if window is None else int(window), scale,
            None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attention_cuda: launch failed with CUDA "
                           f"error {err} ({msg})")
    launches += 1
    return (out, lse) if return_lse else out


def _check_grad_masks(q, k, *, q_offset: int = 0, kv_len: int | None = None,
                     window: int | None = None) -> None:
    """Raise ``ValueError`` for the masks the backward does not take: it
    covers causal (from ``q_offset`` 0) or unmasked attention over the
    full kv length."""
    if window is not None:
        raise ValueError("flash attention backward: a sliding window has "
                         "no gradient kernel")
    if int(q_offset) != 0:
        raise ValueError(f"flash attention backward: q_offset {q_offset} "
                         f"!= 0 has no gradient kernel")
    if kv_len is not None and int(kv_len) != k.shape[1]:
        raise ValueError(f"flash attention backward: kv_len {kv_len} < Sk "
                         f"{k.shape[1]} has no gradient kernel")


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             scale: float | None = None):
    """Launch K2's backward: (dq, dk, dv) in the dtypes of q, k and v
    (see :data:`plain_bwd` for the function).  o and lse come from the
    forward (:func:`flash_attention_cuda` with ``return_lse``)."""
    global bwd_launches
    _check(q, k, v)
    for name, t, shape in (("o", o, q.shape), ("do", do, q.shape),
                           ("lse", lse, (q.shape[0], q.shape[2],
                                         q.shape[1]))):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd_cuda: {name} is on "
                             f"{t.device}, q on {q.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"flash_attention_bwd_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be "
                             f"contiguous")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd_cuda: o/do must be {q.dtype}, "
                        f"got {o.dtype}/{do.dtype}")
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd_cuda: lse must be float32, "
                        f"got {lse.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = load_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, sq, sk, h,
            k.shape[2], d, int(bool(causal)), scale, stream)
    if err != 0:
        msg = lib.flash_attn_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd_cuda: launch failed with "
                           f"CUDA error {err} ({msg})")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K2 with a gradient: the forward launches the forward kernel with
    its log-sum-exp, the backward launches the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              kv_len: int | None = None, window: int | None = None,
              scale: float | None = None):
    """K2 on CUDA tensors, differentiable: when autograd asks for a
    gradient of q, k or v it runs :class:`FlashAttention` (a mask without
    a gradient kernel raises ``ValueError``); otherwise one forward
    launch, without the log-sum-exp."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _check_grad_masks(q, k, q_offset=q_offset, kv_len=kv_len,
                         window=window)
        return FlashAttention.apply(q, k, v, bool(causal), scale)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset,
                                kv_len=kv_len, window=window, scale=scale)
