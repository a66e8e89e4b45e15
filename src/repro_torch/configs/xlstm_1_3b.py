"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304;
sLSTM + mLSTM blocks at ratio 7:1 (xLSTM[7:1]). [arXiv:2405.04517]

48 layers = 6 units of 7 mLSTM + 1 sLSTM.  ``d_inner`` is 2 x 2048, so
an mLSTM head is 4096 / 4 = 1024 wide (``head_dim`` is not read).  The
model as the reference builds it holds 3.70 B params (dense 4096 x 4096
q, k and v projections in every mLSTM layer), not the published 1.3 B.
"""

from repro_torch.configs.base import XLSTMConfig

CONFIG = XLSTMConfig(
    name="xlstm-1.3b", arch_type="ssm",
    num_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab_size=50304,
    proj_factor=2.0, conv_kernel=4, mlstm_per_unit=7, slstm_per_unit=1,
    chunk_len=64,
    source="arXiv:2405.04517",
)

SMOKE_CONFIG = CONFIG.replace(
    name="xlstm-smoke", num_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, vocab_size=512, mlstm_per_unit=1, slstm_per_unit=1,
    chunk_len=16)
