"""PyTorch + CUDA port of the PatrickStar reproduction (Hopper, sm_90a).

The JAX package ``repro`` is the reference; this package mirrors its
module names (``configs/``, ``core/``, ``kernels/``, ``models/``) so each
counterpart is easy to find.  It imports ``torch`` and ``numpy`` only —
never ``jax`` and never ``repro.*``; the pure-Python reference modules it
needs are kept as copies.

Entry points take an explicit ``device``, defaulting to ``"cuda"``.
Asking for CUDA on a machine without it raises; only an explicit
``device="cpu"`` runs on the CPU (which is what the parity tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.  ``"cuda"`` without a
    usable card raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
