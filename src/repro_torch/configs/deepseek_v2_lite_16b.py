"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408
vocab=102400; MLA kv_lora=512, shared + routed experts top-6.
[arXiv:2405.04434]

64 routed experts of 1408 (the published V2-Lite card) top-6, 2 shared
experts, one leading dense layer (d_ff 10944).  MLA attention in the MoE
layers: q/k head dim 128 + 64 (RoPE), value head dim 128, a 512-wide
latent KV.  As in the reference's model (``repro.models.moe_lm``), the
leading dense layer takes GQA attention at head dim 128, where the
released model's first layer has MLA too.
"""

from repro_torch.configs.base import MoEConfig

CONFIG = MoEConfig(
    name="deepseek-v2-lite-16b", arch_type="moe",
    num_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944,            # dense first-layer ffn
    d_ff_expert=1408, vocab_size=102400,
    n_experts=64, top_k=6, n_shared_experts=2, first_dense_layers=1,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    activation="silu", gated_mlp=True,
    moe_impl="ep",  # 64 experts over a 16-way model axis -> expert parallel
    source="arXiv:2405.04434",
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-v2-lite-smoke", num_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=256, d_ff_expert=64, vocab_size=512,
    n_experts=4, top_k=2, n_shared_experts=1, first_dense_layers=1,
    kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
    moe_impl="tp")
