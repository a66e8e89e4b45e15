"""Architecture config registry of the port (dense family only)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import BaseConfig

ARCH_IDS = [
    "qwen3-0.6b",
    # the paper's own workload family (GPT-2-like ladder, Table 2)
    "gpt2-paper-1b",
]


def _module(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, *, smoke: bool = False) -> BaseConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(_module(arch_id))
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def model_class(cfg: BaseConfig):
    """Map a config to its Model class (dense only in this port slice)."""
    if cfg.arch_type == "dense":
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM
    raise KeyError(f"arch_type {cfg.arch_type!r} is not ported yet")
