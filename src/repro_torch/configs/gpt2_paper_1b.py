"""The paper's own GPT-2-like workload (Table 2): 1B = 20 layers,
hidden 2048, 16 heads, seq 1024, vocab 50257."""

from repro_torch.configs.base import BaseConfig

CONFIG = BaseConfig(
    name="gpt2-paper-1b", arch_type="dense",
    num_layers=20, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304,
    activation="gelu", gated_mlp=False, norm="ln",
    source="PatrickStar Table 2",
)

SMOKE_CONFIG = CONFIG.replace(
    name="gpt2-paper-smoke", num_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=512, vocab_size=512)
