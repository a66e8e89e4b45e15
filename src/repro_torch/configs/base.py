"""Config schema of the port: the reference's dense ``BaseConfig``, its
``MoEConfig``, its ``XLSTMConfig`` (xLSTM), its ``HybridConfig`` (zamba2),
its ``EncDecConfig`` (whisper), its ``VLMConfig`` (phi-3-vision) and a
torch ``dtype_of``."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


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

    # which input shapes this arch runs; long_500k only for sub-quadratic
    # families (the reference's rule)
    def supported_shapes(self) -> list[str]:
        shapes = ["train_4k", "prefill_32k", "decode_32k"]
        if self.subquadratic_decode:
            shapes.append("long_500k")
        return shapes

    @property
    def subquadratic_decode(self) -> bool:
        return self.sliding_window is not None

    def replace(self, **kw) -> "BaseConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MoEConfig(BaseConfig):
    arch_type: str = "moe"
    n_experts: int = 8
    top_k: int = 2
    n_shared_experts: int = 0
    d_ff_expert: int = 512  # per-expert ffn width
    first_dense_layers: int = 0  # leading dense layers (deepseek-v2 style)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "tp"  # "tp": experts ffn-sharded | "ep": experts sharded
    # MLA (deepseek-v2) attention, enabled when kv_lora_rank > 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    @property
    def use_mla(self) -> bool:
        return self.kv_lora_rank > 0


@dataclasses.dataclass(frozen=True)
class XLSTMConfig(BaseConfig):
    """xLSTM: blocks of mLSTM with interleaved sLSTM (ratio a:b)."""

    arch_type: str = "ssm"
    proj_factor: float = 2.0  # d_inner = proj_factor * d_model
    conv_kernel: int = 4
    mlstm_per_unit: int = 7  # xLSTM[7:1]
    slstm_per_unit: int = 1
    chunk_len: int = 64  # chunkwise-parallel mLSTM block length

    @property
    def subquadratic_decode(self) -> bool:
        return True  # recurrent state decode

    @property
    def num_units(self) -> int:
        per = self.mlstm_per_unit + self.slstm_per_unit
        assert self.num_layers % per == 0, (self.num_layers, per)
        return self.num_layers // per

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)


@dataclasses.dataclass(frozen=True)
class HybridConfig(BaseConfig):
    """Zamba2-style: Mamba2 backbone + one shared attention block."""

    arch_type: str = "hybrid"
    ssm_state: int = 64
    mamba_headdim: int = 64
    mamba_expand: int = 2
    conv_kernel: int = 4
    shared_interval: int = 6  # shared attn applied every N mamba layers
    chunk_len: int = 64

    @property
    def subquadratic_decode(self) -> bool:
        return True  # SSM state + a handful of attention caches

    @property
    def num_units(self) -> int:
        return self.num_layers // self.shared_interval

    @property
    def tail_layers(self) -> int:
        """Mamba layers left over after the last shared-attention unit."""
        return self.num_layers % self.shared_interval

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_heads(self) -> int:
        return self.d_inner // self.mamba_headdim


@dataclasses.dataclass(frozen=True)
class EncDecConfig(BaseConfig):
    """Whisper-style encoder-decoder; conv/mel frontend is a stub that
    provides precomputed frame embeddings."""

    arch_type: str = "audio"
    num_encoder_layers: int = 2
    encoder_frames: int = 1500  # encoder positions fed by the stub frontend
    frontend_dim: int = 128  # stub frame-embedding dim

    @property
    def subquadratic_decode(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class VLMConfig(BaseConfig):
    """Phi-3-vision-style: language decoder consuming stub patch embeds."""

    arch_type: str = "vlm"
    num_patches: int = 576
    vision_dim: int = 1024  # stub patch-embedding dim (pre-projector)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
