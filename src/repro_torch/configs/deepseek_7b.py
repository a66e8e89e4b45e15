"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400; llama-arch. [arXiv:2401.02954]"""

from repro_torch.configs.base import BaseConfig

CONFIG = BaseConfig(
    name="deepseek-7b", arch_type="dense",
    num_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400,
    activation="silu", gated_mlp=True,
    source="arXiv:2401.02954",
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-7b-smoke", num_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512)
