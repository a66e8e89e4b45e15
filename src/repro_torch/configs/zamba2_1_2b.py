"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192,
ssm_state=64; Mamba2 backbone + shared attention block. [arXiv:2411.15242]

38 Mamba2 layers = 6 units of (6 mamba + shared attention) plus a
2-layer mamba tail group (38 % 6), so the assigned layer count is exact.
The shared block runs at 2 x d_model = 4096 wide (32 heads of 128).
"""

from repro_torch.configs.base import HybridConfig

CONFIG = HybridConfig(
    name="zamba2-1.2b", arch_type="hybrid",
    num_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, mamba_headdim=64, mamba_expand=2, conv_kernel=4,
    shared_interval=6, chunk_len=64,
    activation="gelu", gated_mlp=True,
    source="arXiv:2411.15242",
)

SMOKE_CONFIG = CONFIG.replace(
    name="zamba2-smoke", num_layers=5, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=64, d_ff=256, vocab_size=512, ssm_state=16, mamba_headdim=32,
    shared_interval=2, chunk_len=16)
