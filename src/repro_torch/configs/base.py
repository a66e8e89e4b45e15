"""Config schema of the port: the reference's dense ``BaseConfig`` and a
torch ``dtype_of``.  The other families (MoE, SSM, hybrid, audio, VLM)
join with the slices that port their models."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    name: str = "unnamed"
    arch_type: str = "dense"
    num_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024
    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    # mlp flavour
    activation: str = "silu"
    gated_mlp: bool = True
    # norm flavour
    norm: str = "rms"  # "rms" | "ln"
    tie_embeddings: bool = True
    # numerics
    param_dtype: str = "bfloat16"  # chunk-store dtype (paper's "param fp16")
    compute_dtype: str = "bfloat16"
    # provenance
    source: str = ""

    def replace(self, **kw) -> "BaseConfig":
        return dataclasses.replace(self, **kw)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
