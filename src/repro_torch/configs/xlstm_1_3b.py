"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L, d_model=2048, 4 heads (kv=4), d_ff=0 (the mLSTM block's up/down
projections play the FFN role), vocab=50304.  One sLSTM block per 8 layers
(groups of 7 mLSTM + 1 sLSTM).  Deviations from the official code are noted
in models/xlstm.py.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=0, norm="layernorm", gated_ffn=False,
    rope_pct=0.0,  # xLSTM has no attention, hence no RoPE
    ssm=SSMConfig(d_state=0, expand=2, head_dim=0, chunk=256, slstm_every=8),
    grad_accum=4,
)
