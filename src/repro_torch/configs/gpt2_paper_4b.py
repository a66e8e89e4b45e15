"""The paper's GPT-2-like 4B config (Table 2): 64 layers, hidden 2304."""

from repro_torch.configs.base import BaseConfig

CONFIG = BaseConfig(
    name="gpt2-paper-4b", arch_type="dense",
    num_layers=64, d_model=2304, n_heads=16, n_kv_heads=16, head_dim=144,
    d_ff=9216, vocab_size=50304,
    activation="gelu", gated_mlp=False, norm="ln",
    source="PatrickStar Table 2",
)

SMOKE_CONFIG = CONFIG.replace(
    name="gpt2-paper-4b-smoke", num_layers=2, d_model=144, n_heads=4,
    n_kv_heads=4, head_dim=36, d_ff=576, vocab_size=512)
