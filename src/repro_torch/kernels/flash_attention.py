"""K2 on Hopper: the flash-attention forward as a hand-written CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_kernel``, ``pallas_call`` at line 92).  The source is
``csrc/flash_attention.cu``; its header states what the kernel computes,
its bound on an H100 and what the design does about it.  It is built with
``nvcc`` for ``sm_90a`` at first use (:mod:`repro_torch.kernels.build`)
and bound through a plain C interface with ``ctypes``.

:func:`flash_attention_cuda` is the wrapper: it checks device, dtype,
shape and contiguity and raises on anything the kernel does not take,
allocates the output with ``torch.empty``, launches on the current stream,
raises if the launch returns a CUDA error, and adds one to
:data:`launches` per launch.  Its plain PyTorch version is
:data:`plain` (:func:`repro_torch.kernels.ref.flash_attention_ref`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref as plain

SOURCE = "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:92"
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (a plain count, read by chip_smoke)
launches = 0
_lib: ctypes.CDLL | None = None

__all__ = ["flash_attention_cuda", "plain", "launches", "load"]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.library(SOURCE)))
        lib.flash_attn_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attn_fwd.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
                         scale: float | None = None) -> torch.Tensor:
    """Launch K2: out [B,Sq,H,D] in q's dtype (see :data:`plain` for the
    function)."""
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
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, h, k.shape[2], d, q_offset, kv_len,
            int(bool(causal)), 0 if window is None else int(window), scale,
            stream)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attention_cuda: launch failed with CUDA "
                           f"error {err} ({msg})")
    launches += 1
    return out
