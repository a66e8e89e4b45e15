"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (GQA kv=32)
d_ff=8192 vocab=32064; phi3-mini decoder + CLIP stub frontend.
[hf:microsoft/Phi-3-vision-128k-instruct]

The stub frontend hands the decoder 576 patch embeddings of width 1024
(a 24 x 24 CLIP ViT-L/14 grid at 336 px); a 2-layer projector brings them
to d_model ahead of the text.
"""

from repro_torch.configs.base import VLMConfig

CONFIG = VLMConfig(
    name="phi-3-vision-4.2b", arch_type="vlm",
    num_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    num_patches=576, vision_dim=1024,
    activation="silu", gated_mlp=True,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE_CONFIG = CONFIG.replace(
    name="phi3v-smoke", num_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512, num_patches=16, vision_dim=64)
