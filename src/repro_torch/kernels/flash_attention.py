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

Which kernel a call runs is decided here, in Python, by dtype and shape
(:func:`plan_forward`, :func:`plan_backward`), and passed to the one C
entry of each source:

* ``tc`` — bf16 with Sq >= 16 (prefill, training, the backward's
  recompute), and the bf16 backward: wgmma on the tensor cores, tiles
  brought in by TMA;
* ``splitkv`` — Sq < 16 in either dtype (decode): one block per kv split,
  then a kernel that combines the splits;
* ``tf32x3`` — fp32 with Sq >= 16, forward and backward: the tensor cores
  through warp-level ``mma.sync``, every product split into three TF32
  products (``a_lo b_hi + a_hi b_lo + a_hi b_hi``, ``csrc/tf32.cuh``),
  which holds the fp32 parity phases' 1e-4 where a single TF32 product
  would not; :func:`repro_torch.kernels.ref.tf32_matmul` is its plain
  model (the ``matmul`` of the plain forward and backward).  At the
  training shape (B=8, S=1024, H=16, D=128, causal) the forward's 34.4
  GFLOP bound it: 0.209 ms as three TF32 products on the tensor cores,
  against 0.513 ms on the FMA pipes (and 0.080 ms of bytes).  Its loop is
  bound by each warp's chain of shared loads, splits and products, so a
  block is eight warps of 16 query rows, each keeping its O in registers
  while a cp.async ring brings the next 64 K and V rows.

Every schedule takes q/k and value head dims ``(D, Dv)`` of
:data:`HEAD_PAIRS`: ``(d, d)`` for d in :data:`HEAD_DIMS` (32, 64,
phi-3-vision's 96, 128, gpt2-paper-4b's 144 and nemotron-4-340b's 192; at
96 and 144 the ``tc`` tiles are six and nine 16-column TMA boxes with the
32B swizzle, ``csrc/hopper.cuh``; at 192 three 64-column ones, and the
fp32 backward's blocks hold 64 resident rows where the others hold 128),
and MLA's ``(192, 128)``
(deepseek-v2-lite: ``qk_nope`` 128 + ``qk_rope`` 64 against ``v_head_dim``
128), which the ``tc`` and ``tf32x3`` schedules take, forward and
backward; no path decodes through that pair (MLA decodes over its latent
cache), so ``splitkv`` does not, and a short prefill at (192, 128) runs
the 128-row schedules.  Another pair raises.

This is a dispatch, not a fallback: a bf16 tensor never reaches an fp32
kernel, and a failed build or launch raises.

The wrappers check device, dtype, shape and contiguity and raise on
anything the kernels do not take, allocate outputs and scratch with
``torch.empty``, launch on the current stream, raise if a launch returns
a CUDA error, and count their launches:

* :func:`flash_attention_cuda` — the forward (:data:`launches`): out
  [B, Sq, H, Dv] in q's dtype, for v of shape [B, Sk, KV, Dv]; with
  ``return_lse`` it also returns the fp32 log-sum-exp the backward needs;
  with ``kv_lens`` (int32 [B] on the card) each row's keys stop at its own
  length, read from device memory, so a CUDA graph can replay the call
  after the lengths change.  A call made while its stream is being
  captured into a CUDA graph launches nothing: it counts in
  :data:`captured`, and the graph's owner counts the replays;
* :func:`flash_attention_bwd_cuda` — the backward (:data:`bwd_launches`,
  one per call of its three kernels, four where dK and dV take a launch
  each for the registers: fp32 at (192, 128), both dtypes at (192, 192));
* :class:`FlashAttention` — the ``torch.autograd.Function`` joining them,
  and :func:`attention`, the entry the port's layers reach on a CUDA
  tensor: the autograd path when a gradient is asked for, the plain
  forward launch otherwise.

Their plain PyTorch versions are :data:`plain` and :data:`plain_bwd`
(:mod:`repro_torch.kernels.ref`).
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import NamedTuple

import numpy as np
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
HEAD_DIMS = (32, 64, 96, 128, 144, 192)
# (q/k head dim, value head dim) pairs the kernels take: (192, 128) is
# deepseek-v2-lite's MLA (qk_nope 128 + qk_rope 64, v_head_dim 128)
HEAD_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SCHEDULES = {"tc": 1, "splitkv": 2, "tf32x3": 3}  # C codes
SPLITKV_MAX_SQ = 15   # query rows up to which the split-kv kernel runs
SPLIT_GRAIN = 64      # kv rows: a split holds a whole number of these
SPLITKV_BLOCKS = 8 * 132  # split-kv blocks to aim for: 8 per H100 SM

# kernel launches since the last reset (plain counts, read by chip_smoke);
# forward calls recorded into a CUDA graph under capture count apart; the
# same launches by (q/k head dim, value head dim) beside them
launches = 0
captured = 0
bwd_launches = 0
pair_launches: collections.Counter = collections.Counter()
bwd_pair_launches: collections.Counter = collections.Counter()
_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda",
           "FlashAttention", "attention", "plain", "plain_bwd", "launches",
           "bwd_launches", "captured", "pair_launches", "bwd_pair_launches",
           "load", "load_bwd", "ForwardPlan",
           "plan_forward", "plan_backward", "HEAD_DIMS", "HEAD_PAIRS"]


def forward_work(b: int, sq: int, sk: int, h: int, kv: int, d: int,
                 dv: int, itemsize: int, *, causal: bool = True,
                 q_offset: int = 0, kv_len: int | None = None,
                 window: int | None = None, kv_lens=None) -> dict:
    """The forward's work on one call's inputs: ``bytes``, each input
    byte the masks let through read once and the output written once
    (q and k at D, v and the output at Dv), and ``flops``, 2 (D + Dv) a
    visible (query, key) pair a head (S = Q K^T and P V).  ``kv_lens``
    (a sequence of ints, one a row) bounds each row on its own.  The
    count ``chip_smoke.py``'s bound column and the dry-run
    (:mod:`repro_torch.launch.dryrun`) share."""
    if kv_lens is not None:
        pairs = sq * sum(kv_lens)
        return dict(bytes=itemsize * (b * sq * h * (d + dv)
                                      + sum(kv_lens) * kv * (d + dv)),
                    flops=2 * (d + dv) * h * pairs)
    kv_len = sk if kv_len is None else kv_len
    pos = q_offset + np.arange(sq, dtype=np.int64)  # each query's position
    hi = np.minimum(kv_len, pos + 1) if causal else np.full(sq, kv_len)
    lo = np.maximum(0, pos - window + 1) if window else 0
    pairs = int(np.maximum(0, hi - lo).sum())
    return dict(bytes=itemsize * (b * sq * h * (d + dv)
                                  + b * kv_len * kv * (d + dv)),
                flops=2 * (d + dv) * b * h * pairs)


def backward_work(b: int, s: int, h: int, kv: int, d: int, dv: int,
                  itemsize: int, *, causal: bool = True,
                  window: int | None = None, sk: int | None = None) -> dict:
    """The backward's work: ``bytes`` of q, k, v, o, dO, dQ, dK and dV once
    each at their own head dims (q, k, dQ, dK at D; v, o, dO, dV at Dv),
    plus the fp32 lse and delta; ``flops``, five products a visible
    (query, key) pair a head, 2 (3 D + 2 Dv) in all (S recomputed from the
    lse, dK and dQ at 2 D each, dP and dV at 2 Dv).  ``sk``: the key rows
    where they differ from the query rows (unmasked cross-attention).
    Shared with ``chip_smoke.py`` and the dry-run as
    :func:`forward_work` is."""
    sk = s if sk is None else sk
    nbytes = itemsize * (2 * b * s * h * (d + dv)
                         + 2 * b * sk * kv * (d + dv)) + 2 * 4 * b * h * s
    i = np.arange(s, dtype=np.int64)
    hi = i + 1 if causal else np.full(s, sk)
    lo = np.maximum(0, i - window + 1) if window else 0
    pairs = int((hi - lo).sum())
    return dict(bytes=nbytes, flops=2 * (3 * d + 2 * dv) * b * h * pairs)


class ForwardPlan(NamedTuple):
    """How one forward call runs: the schedule and, for ``splitkv``, the
    splits: split s covers kv rows
    ``[split_lo + s * split_rows, split_lo + (s + 1) * split_rows)``.
    The C entry sizes the grid from these and its own tile sizes."""

    schedule: str
    splits: int = 1
    split_lo: int = 0
    split_rows: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_forward(b: int, sq: int, sk: int, h: int, dtype, *,
                 kv_len: int | None = None, q_offset: int = 0,
                 causal: bool = True, window: int | None = None,
                 head_dims: tuple[int, int] | None = None) -> ForwardPlan:
    """The forward's schedule for these shapes (a pure function; the CPU
    tests check it).  ``head_dims``: (D, Dv), where they differ (MLA's
    (192, 128)) every Sq takes the 128-row schedule of its dtype, which
    has the pair; ``splitkv`` does not.  Otherwise Sq < 16 takes
    ``splitkv`` in either dtype: the kv
    rows any query row can see are cut into splits of whole 64-row tiles,
    as few tiles a split as still give about :data:`SPLITKV_BLOCKS`
    blocks, and every split holds at least one visible key of the first
    query row.  Per-row lengths from the device (``kv_lens``) have no host
    value to plan from: such a call passes no ``kv_len`` and no causal
    cut, so the splits cover the whole horizon ``sk`` and a short row
    leaves most of them empty.  Otherwise bf16 takes ``tc`` and fp32
    ``tf32x3`` (128 query rows a block each)."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in _DTYPES:
        raise TypeError(f"plan_forward: dtype {dtype} is neither float32 "
                        f"nor bfloat16")
    pair = head_dims is not None and head_dims[0] != head_dims[1]
    if sq <= SPLITKV_MAX_SQ and not pair:
        hi = min(sk if kv_len is None else kv_len, sk)
        if causal:
            hi = min(hi, q_offset + sq)
        lo = max(0, q_offset - window + 1) if window else 0
        lo = lo // SPLIT_GRAIN * SPLIT_GRAIN
        tiles = max(1, _cdiv(hi - lo, SPLIT_GRAIN))
        most = max(1, _cdiv(SPLITKV_BLOCKS, b * h * sq))
        rows = _cdiv(tiles, most) * SPLIT_GRAIN
        splits = max(1, _cdiv(hi - lo, rows))
        return ForwardPlan("splitkv", splits, lo, rows)
    return ForwardPlan("tc" if dtype == torch.bfloat16 else "tf32x3")


def plan_backward(dtype) -> str:
    """The backward's schedule: ``tc`` for bf16, ``tf32x3`` for fp32."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in _DTYPES:
        raise TypeError(f"plan_backward: dtype {dtype} is neither float32 "
                        f"nor bfloat16")
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def load() -> ctypes.CDLL:
    """Build (if needed) and load the forward kernel's library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.library(SOURCE)))
        lib.flash_attn_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
            + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 5)
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
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attn_bwd.restype = ctypes.c_int
        lib.flash_attn_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _on_device(device, fn, args) -> int:
    """Call a C entry with ``args`` and the current stream of ``device``,
    with ``device`` current (entering it only when it is not already)."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _on_device(device, fn, args)
    return fn(*args, torch.cuda.current_stream(device).cuda_stream)


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
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b
            or k.shape[3] != d):
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match [B,Sq,H,D] x [B,Sk,KV,D] x [B,Sk,KV,Dv]")
    if (d, v.shape[3]) not in HEAD_PAIRS:
        raise ValueError(f"flash_attention_cuda: head dims (D, Dv) = "
                         f"{(d, v.shape[3])} not in {HEAD_PAIRS}")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention_cuda: {k.shape[2]} kv heads do "
                         f"not divide {h} query heads")
    if min(b, sq, k.shape[1]) < 1 or max(b, sq, h, k.shape[1]) >= 2**31:
        raise ValueError("flash_attention_cuda: empty or oversized dims")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: q, k and v must start on a "
                         "16-byte boundary (TMA and 16-byte loads)")


def _check_kv_lens(q, kv_lens, sq: int) -> None:
    """``kv_lens`` must be int32 [B] on q's device, and the call must take
    the split-kv schedule (the only one that reads it).  Its values stay on
    the device: each must be >= 1, which the caller guarantees (a decode
    slot at position p reads p + 1 keys)."""
    if sq > SPLITKV_MAX_SQ:
        raise ValueError(f"flash_attention_cuda: kv_lens is read by the "
                         f"split-kv (decode) schedule only, Sq <= "
                         f"{SPLITKV_MAX_SQ}; got Sq {sq}")
    if kv_lens.device != q.device or kv_lens.dtype != torch.int32:
        raise TypeError(f"flash_attention_cuda: kv_lens must be int32 on "
                        f"{q.device}, got {kv_lens.dtype} on "
                        f"{kv_lens.device}")
    if tuple(kv_lens.shape) != (q.shape[0],) or not kv_lens.is_contiguous():
        raise ValueError(f"flash_attention_cuda: kv_lens must be a "
                         f"contiguous [B] = [{q.shape[0]}], got shape "
                         f"{tuple(kv_lens.shape)}")


def flash_attention_cuda(q, k, v, *, causal: bool = True, q_offset: int = 0,
                         kv_len: int | None = None,
                         kv_lens: torch.Tensor | None = None,
                         window: int | None = None,
                         scale: float | None = None,
                         return_lse: bool = False):
    """Launch K2: out [B,Sq,H,Dv] in q's dtype (see :data:`plain` for the
    function); with ``return_lse``, (out, lse [B,H,Sq] fp32).  With
    ``kv_lens`` (int32 [B] on the card, each >= 1) row b also sees only
    keys below ``kv_lens[b]``; decode (Sq <= 15, D == Dv) only."""
    global launches, captured
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
    dv = v.shape[3]
    if kv_lens is not None:
        _check_kv_lens(q, kv_lens, sq)
        if dv != d:
            raise ValueError(f"flash_attention_cuda: kv_lens is read by the "
                             f"split-kv schedule, which takes D == Dv only; "
                             f"got {(d, dv)}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    plan = plan_forward(b, sq, sk, h, q.dtype, kv_len=kv_len,
                        q_offset=q_offset, causal=bool(causal),
                        window=None if window is None else int(window),
                        head_dims=(d, dv))
    out = q.new_empty((b, sq, h, dv))
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    parts = (None, None, None)
    if plan.schedule == "splitkv":
        # fp32 partials of every split, in one buffer: acc [B,H,Sq,splits,D]
        # then m and l [B,H,Sq,splits]
        n = b * h * sq * plan.splits
        scratch = torch.empty(n * (d + 2), dtype=torch.float32,
                              device=q.device)
        at = scratch.data_ptr()
        parts = (at, at + 4 * n * d, at + 4 * n * (d + 1))
    lib = load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, h, k.shape[2], d, dv, q_offset,
            kv_len,
            int(bool(causal)), 0 if window is None else int(window), scale,
            None if lse is None else lse.data_ptr(),
            SCHEDULES[plan.schedule], plan.splits,
            plan.split_lo, plan.split_rows, *parts,
            None if kv_lens is None else kv_lens.data_ptr())
    err = _on_device(q.device, lib.flash_attn_fwd, args)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attention_cuda: {plan.schedule} launch "
                           f"failed with error {err} ({msg})")
    if torch.cuda.is_current_stream_capturing():
        captured += 1  # recorded into a graph: it runs at each replay
    else:
        launches += 1
        pair_launches[(d, dv)] += 1
    return (out, lse) if return_lse else out


def _check_grad_masks(q, k, *, q_offset: int = 0, kv_len: int | None = None,
                     window: int | None = None) -> None:
    """Raise ``ValueError`` for the masks the backward does not take: it
    covers causal (from ``q_offset`` 0) or unmasked attention over the
    full kv length, either with a sliding window."""
    if window is not None and int(window) < 1:
        raise ValueError(f"flash attention backward: window {window} < 1")
    if int(q_offset) != 0:
        raise ValueError(f"flash attention backward: q_offset {q_offset} "
                         f"!= 0 has no gradient kernel")
    if kv_len is not None and int(kv_len) != k.shape[1]:
        raise ValueError(f"flash attention backward: kv_len {kv_len} < Sk "
                         f"{k.shape[1]} has no gradient kernel")


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int | None = None,
                             scale: float | None = None):
    """Launch K2's backward: (dq, dk, dv) in the dtypes and shapes of q, k
    and v (see :data:`plain_bwd` for the function); o and do are
    [B,Sq,H,Dv].  o and lse come from the
    forward (:func:`flash_attention_cuda` with ``return_lse``) with the
    same ``causal`` and ``window``; the kernels skip the tiles outside
    the window's band."""
    global bwd_launches
    _check(q, k, v)
    _check_grad_masks(q, k, window=window)
    o_shape = (*q.shape[:3], v.shape[3])
    for name, t, shape in (("o", o, o_shape), ("do", do, o_shape),
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
    if any(t.data_ptr() % 16 for t in (o, do, lse)):
        raise ValueError("flash_attention_bwd_cuda: o, do and lse must "
                         "start on a 16-byte boundary (TMA)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    schedule = plan_backward(q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # scratch rows of Sq rounded up to 4 (16 bytes), so the tc kernels'
    # TMA reads them a tile at a time: rowsum(dO * O), and lse * log2(e)
    sq_pad = _cdiv(sq, 4) * 4
    delta = torch.empty((b, h, sq_pad), dtype=torch.float32, device=q.device)
    lse2 = torch.empty_like(delta) if schedule == "tc" else None
    lib = load_bwd()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if lse2 is None else lse2.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, sq, sk, h,
            k.shape[2], d, v.shape[3], int(bool(causal)),
            0 if window is None else int(window), scale,
            SCHEDULES[schedule])
    err = _on_device(q.device, lib.flash_attn_bwd, args)
    if err != 0:
        msg = lib.flash_attn_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd_cuda: {schedule} launch "
                           f"failed with error {err} ({msg})")
    bwd_launches += 1
    bwd_pair_launches[(d, v.shape[3])] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K2 with a gradient: the forward launches the forward kernel with
    its log-sum-exp, the backward launches the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None,
                scale: float | None):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              kv_len: int | None = None, kv_lens: torch.Tensor | None = None,
              window: int | None = None, scale: float | None = None):
    """K2 on CUDA tensors, differentiable: when autograd asks for a
    gradient of q, k or v it runs :class:`FlashAttention` (a mask without
    a gradient kernel raises ``ValueError``); otherwise one forward
    launch, without the log-sum-exp."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if kv_lens is not None:
            raise ValueError("flash attention backward: per-row kv_lens "
                             "have no gradient kernel")
        _check_grad_masks(q, k, q_offset=q_offset, kv_len=kv_len,
                         window=window)
        return FlashAttention.apply(q, k, v, bool(causal),
                                    None if window is None else int(window),
                                    scale)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset,
                                kv_len=kv_len, kv_lens=kv_lens,
                                window=window, scale=scale)
