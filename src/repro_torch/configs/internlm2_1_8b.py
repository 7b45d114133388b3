"""internlm2-1.8b [dense] — 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.

InternLM2: GQA (2 query heads per kv head), RMSNorm, SwiGLU, full rotary.
[arXiv:2403.17297; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab=92544, norm="rmsnorm", act="silu", gated_ffn=True,
    rope_pct=1.0, rope_base=1_000_000.0,
    grad_accum=2,
)
