"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8)
d_ff=73728 vocab=256000; GQA, squared-ReLU un-gated MLP. [arXiv:2402.16819]"""

from repro_torch.configs.base import BaseConfig

CONFIG = BaseConfig(
    name="nemotron-4-340b", arch_type="dense",
    num_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000,
    activation="relu2", gated_mlp=False, tie_embeddings=False,
    source="arXiv:2402.16819",
)

SMOKE_CONFIG = CONFIG.replace(
    name="nemotron-smoke", num_layers=2, d_model=192, n_heads=4, n_kv_heads=2,
    head_dim=48, d_ff=768, vocab_size=512)
