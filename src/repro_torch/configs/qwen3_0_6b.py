"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm, GQA. [hf:Qwen/Qwen3-8B]"""

from repro_torch.configs.base import BaseConfig

CONFIG = BaseConfig(
    name="qwen3-0.6b", arch_type="dense",
    num_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    qk_norm=True, activation="silu", gated_mlp=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-smoke", num_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512)
