"""whisper-large-v3 [audio] — 32L (decoder) d_model=1280 20H
d_ff=5120 vocab=51866; enc-dec, conv frontend stubbed. [arXiv:2212.04356]

32 encoder layers match the release; the stub frontend feeds the encoder
1500 frame embeddings of width 128 (Whisper's 30 s window).
"""

from repro_torch.configs.base import EncDecConfig

CONFIG = EncDecConfig(
    name="whisper-large-v3", arch_type="audio",
    num_layers=32, num_encoder_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    encoder_frames=1500, frontend_dim=128,
    activation="gelu", gated_mlp=False, norm="ln", use_rope=True,
    source="arXiv:2212.04356",
)

SMOKE_CONFIG = CONFIG.replace(
    name="whisper-smoke", num_layers=2, num_encoder_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
    encoder_frames=32, frontend_dim=16)
