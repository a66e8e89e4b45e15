"""Architecture config registry of the port, the reference's twelve: the
dense family (nemotron-4-340b, the widest, among it),
mixtral-8x7b (MoE with sliding-window attention) and deepseek-v2-lite-16b
(MoE with MLA attention, shared experts and a leading dense layer),
zamba2-1.2b (a Mamba2 backbone with one shared attention block),
xlstm-1.3b (mLSTM and sLSTM blocks at 7:1), whisper-large-v3 (an
encoder-decoder over stub audio frames) and phi-3-vision-4.2b (a decoder
over projected stub patch embeddings and text)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import BaseConfig

ARCH_IDS = [
    "qwen3-0.6b",
    "deepseek-7b",
    "qwen2.5-3b",
    "mixtral-8x7b",
    "deepseek-v2-lite-16b",
    "zamba2-1.2b",
    "xlstm-1.3b",
    "whisper-large-v3",
    "phi-3-vision-4.2b",
    "nemotron-4-340b",
    # the paper's own workload family (GPT-2-like ladder, Table 2)
    "gpt2-paper-1b",
    "gpt2-paper-4b",
]


def _module(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, *, smoke: bool = False) -> BaseConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(_module(arch_id))
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def model_class(cfg: BaseConfig):
    """Map a config to its Model class: dense, MoE (with GQA or MLA
    attention), xLSTM (``ssm``), the zamba2 hybrid, whisper's
    encoder-decoder (``audio``) or phi-3-vision's decoder (``vlm``).  An
    arch type no config defines raises ``KeyError``."""
    if cfg.arch_type == "dense":
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM
    if cfg.arch_type == "moe":
        from repro_torch.models.moe_lm import MoELM
        return MoELM
    if cfg.arch_type == "ssm":
        from repro_torch.models.xlstm_lm import XLSTMLM
        return XLSTMLM
    if cfg.arch_type == "hybrid":
        from repro_torch.models.zamba import ZambaLM
        return ZambaLM
    if cfg.arch_type == "audio":
        from repro_torch.models.whisper import WhisperBackbone
        return WhisperBackbone
    if cfg.arch_type == "vlm":
        from repro_torch.models.vlm import VLMBackbone
        return VLMBackbone
    raise KeyError(f"unknown arch_type {cfg.arch_type!r}")
