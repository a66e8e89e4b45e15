"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936; GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""

from repro_torch.configs.base import BaseConfig

CONFIG = BaseConfig(
    name="qwen2.5-3b", arch_type="dense",
    num_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936,
    qkv_bias=True, activation="silu", gated_mlp=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen2.5-smoke", num_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512)
