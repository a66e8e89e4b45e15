"""Public kernel entry points of the port: the hand-written kernel for a
CUDA tensor, its plain PyTorch version for a CPU tensor, and nothing
else — a CUDA tensor never reaches the plain version, and a failed build
or launch raises."""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: int | None = None, window: int | None = None,
                    scale: float | None = None):
    """[B,Sq,H,D] x [B,Sk,KV,D] attention (see
    :func:`~repro_torch.kernels.ref.flash_attention_ref`)."""
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              window=window, scale=scale)
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q, k, v, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_ref(q, k, v, **kw)
