"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000; 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""

from repro_torch.configs.base import MoEConfig

CONFIG = MoEConfig(
    name="mixtral-8x7b", arch_type="moe",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, d_ff_expert=14336, vocab_size=32000,
    n_experts=8, top_k=2, n_shared_experts=0,
    sliding_window=4096,
    activation="silu", gated_mlp=True,
    moe_impl="tp",
    source="arXiv:2401.04088",
)

SMOKE_CONFIG = CONFIG.replace(
    name="mixtral-smoke", num_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, d_ff_expert=256, vocab_size=512, n_experts=4,
    top_k=2, sliding_window=32)
