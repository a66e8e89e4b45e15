"""Public kernel entry points of the port: the hand-written kernel for a
CUDA tensor, its plain PyTorch version for a CPU tensor, and nothing
else — a CUDA tensor never reaches the plain version, and a failed build
or launch raises."""

from __future__ import annotations

from repro_torch.kernels import chunked_adam as _adam
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.ref import adam_ref, flash_attention_ref


def _device_of(t) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: int | None = None, kv_lens=None,
                    window: int | None = None, scale: float | None = None):
    """[B,Sq,H,D] x [B,Sk,KV,D] x [B,Sk,KV,Dv] -> [B,Sq,H,Dv] attention (see
    :func:`~repro_torch.kernels.ref.flash_attention_ref`), differentiable:
    on a CUDA tensor K2 and its backward kernel
    (:func:`repro_torch.kernels.flash_attention.attention`), on a CPU
    tensor the plain version, which autograd differentiates.  ``kv_lens``
    (int32 [B] on q's device) bounds each row's keys on top of the other
    masks (on the card: decode only)."""
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              kv_lens=kv_lens, window=window, scale=scale)
    if _device_of(q) == "cuda":
        return _fa.attention(q, k, v, **kw)
    return flash_attention_ref(q, k, v, **kw)


def chunked_adam(p32, m, v, g, *, out, lr, beta1, beta2, eps, weight_decay,
                 bias_corr1, bias_corr2) -> None:
    """Fused ADAM over flat chunk payloads, in place: p32, m and v (fp32)
    take their updated values, and ``out`` (fp32 or bf16, and it may be
    ``g`` itself) the updated params cast to its dtype.  On a
    CUDA tensor K1 (:mod:`repro_torch.kernels.chunked_adam`), on a CPU
    tensor the plain version (:func:`~repro_torch.kernels.ref.adam_ref`)."""
    hp = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, bias_corr1=bias_corr1,
              bias_corr2=bias_corr2)
    if _device_of(p32) == "cuda":
        _adam.chunked_adam_triton(p32, m, v, g, out, **hp)
        return
    p_new, m_new, v_new = adam_ref(p32, m, v, g, **hp)
    p32.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    out.copy_(p_new)
