"""K1 on Hopper: fused chunked ADAM as a Triton kernel.

Replaces the TPU kernel ``src/repro/kernels/chunked_adam.py``
(``chunked_adam_kernel``, body ``_adam_kernel`` at line 28,
``pallas_call`` at line 74).  Per element, in fp32:

    m' = b1 m + (1 - b1) g
    v' = b2 v + (1 - b2) g^2
    p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p)

p32, m and v are updated in place, and p' is also written, cast, into a
fourth output in the param dtype (bf16 or fp32): the copy of the updated
fp32 params back into the param chunk (the paper's Section 6.2).

Bound on an H100 SXM: nothing crosses elements and each element costs
~15 flops, so bytes bound it.  Reading p, m, v (12 B) and g and writing
p, m, v (12 B) and the fourth output moves 12 + g + 12 + out bytes per
element: 32 B/element on the engine's path (fp32 g and fp32 out), so one
gpt2-paper-1b param chunk (35.65M elements) needs 1.14 GB -> 0.34 ms at
3.35 TB/s.  The design is one pass with nothing else in it: one program
per block of ``BLOCK`` elements, contiguous loads the compiler vectorises
to 16 bytes, fp32 arithmetic with IEEE-rounded division and square root
(the plain version's numbers), and a masked tail instead of padding
(chunk payloads are not multiples of the block).  lr, b1, b2, eps, wd and
the bias corrections bc1, bc2 are runtime fp32 arguments, so a new step
never recompiles.

The fourth output may be the same tensor as g: the engine's grad chunk
reuses the param chunk's payload (Fig. 6), and the updated params go
back into it.  Each program loads its g block before it stores that block
of the output, and no program touches another's block, so the alias is
safe.

Triton is imported, and the kernel compiled, at the first launch, never
at import.  The module leaves Triton's cache where the process's
``TRITON_CACHE_DIR`` puts it; ``chip_smoke.py`` sets that to
:data:`TRITON_CACHE`, ``build/triton/`` at the root of the checkout (a
directory ``.gitignore`` lists).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import BUILD_ROOT
from repro_torch.kernels.ref import adam_ref as plain

SOURCE = "src/repro_torch/kernels/chunked_adam.py"
REPLACES = "src/repro/kernels/chunked_adam.py:50"
BLOCK = 2048  # elements per program
NUM_WARPS = 4  # 128 threads: 16 elements, four 16-byte loads, per thread
TRITON_CACHE = BUILD_ROOT.parent / "triton"
_OUT_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the last reset (a plain count, read by chip_smoke)
launches = 0
_kernel = None

__all__ = ["chunked_adam_triton", "plain", "launches", "load"]


def work(n: int, g_itemsize: int = 4, out_itemsize: int = 4) -> dict:
    """K1's ``bytes`` over ``n`` elements (module docstring: p, m, v and
    g read, p, m, v and the output written); elementwise, so no products
    (``flops`` 0).  Shared with ``chip_smoke.py``'s bound and the
    dry-run (:mod:`repro_torch.launch.dryrun`)."""
    return dict(bytes=n * (12 + g_itemsize + 12 + out_itemsize), flops=0)


def load():
    """Import Triton and define the kernel (compiled at its first
    launch)."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def _adam_kernel(p_ptr, m_ptr, v_ptr, g_ptr, out_ptr, n,
                     lr, b1, b2, eps, wd, bc1, bc2,
                     BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        p = tl.load(p_ptr + offs, mask=mask, other=0.0)
        m = tl.load(m_ptr + offs, mask=mask, other=0.0)
        v = tl.load(v_ptr + offs, mask=mask, other=0.0)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        denom = tl.sqrt_rn(tl.div_rn(v, bc2)) + eps
        upd = tl.div_rn(tl.div_rn(m, bc1), denom) + wd * p
        p = p - lr * upd
        tl.store(p_ptr + offs, p, mask=mask)
        tl.store(m_ptr + offs, m, mask=mask)
        tl.store(v_ptr + offs, v, mask=mask)
        tl.store(out_ptr + offs, p.to(out_ptr.dtype.element_ty), mask=mask)

    _kernel = (triton, _adam_kernel)
    return _kernel


def _check(p32, m, v, g, out):
    for name, t in (("p32", p32), ("m", m), ("v", v), ("g", g),
                    ("out", out)):
        if t.device.type != "cuda":
            raise ValueError(f"chunked_adam_triton: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != p32.device:
            raise ValueError("chunked_adam_triton: tensors on different "
                             "devices")
        if not t.is_contiguous():
            raise ValueError(f"chunked_adam_triton: {name} must be "
                             f"contiguous")
        if t.numel() != p32.numel():
            raise ValueError(f"chunked_adam_triton: {name} has "
                             f"{t.numel()} elements, p32 {p32.numel()}")
    for name, t in (("p32", p32), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"chunked_adam_triton: {name} must be float32, "
                            f"got {t.dtype}")
    if g.dtype not in _OUT_DTYPES or out.dtype not in _OUT_DTYPES:
        raise TypeError(f"chunked_adam_triton: g and out must be float32 "
                        f"or bfloat16, got {g.dtype} and {out.dtype}")
    # g and out may alias (grad reuse); p32, m and v are each their own
    # memory
    ptrs = [t.data_ptr() for t in (p32, m, v, g, out)]
    if any(ptrs[i] == ptrs[j] for i in range(3) for j in range(5) if i != j):
        raise ValueError("chunked_adam_triton: p32, m and v must not "
                         "share memory with each other or with g/out")


def chunked_adam_triton(p32, m, v, g, out, *, lr, beta1, beta2, eps,
                        weight_decay, bias_corr1, bias_corr2) -> None:
    """Launch K1 on flat (any shape, contiguous) chunk payloads: p32, m
    and v are updated in place and p' is written into ``out`` in its own
    dtype; ``out`` may be ``g`` itself."""
    global launches
    _check(p32, m, v, g, out)
    n = p32.numel()
    if n == 0:
        return
    triton, kernel = load()
    grid = (triton.cdiv(n, BLOCK),)
    with torch.cuda.device(p32.device):
        kernel[grid](p32, m, v, g, out, n, float(lr), float(beta1),
                     float(beta2), float(eps), float(weight_decay),
                     float(bias_corr1), float(bias_corr2), BLOCK=BLOCK,
                     num_warps=NUM_WARPS)
    launches += 1
