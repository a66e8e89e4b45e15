"""Architecture config registry of the port: the dense family,
mixtral-8x7b (MoE with sliding-window attention) and deepseek-v2-lite-16b
(MoE with MLA attention, shared experts and a leading dense layer),
zamba2-1.2b (a Mamba2 backbone with one shared attention block) and
xlstm-1.3b (mLSTM and sLSTM blocks at 7:1)."""

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
    attention), xLSTM (``ssm``) or the zamba2 hybrid.  The other families
    (``vlm``, ``audio``) raise until their slices of the port (ROADMAP)."""
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
    raise KeyError(f"arch_type {cfg.arch_type!r} is not ported yet")
