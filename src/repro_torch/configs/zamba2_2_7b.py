"""zamba2-2.7b [hybrid] — 54L d=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Mamba2 backbone + ONE shared attention+FFN block applied
every 6 layers (9 applications, one parameter set) — Zamba2's
parameter-sharing design. [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, norm="rmsnorm", act="silu", gated_ffn=True,
    attn_every=6,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, chunk=256),
    grad_accum=8,
)
