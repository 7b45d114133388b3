"""stablelm-3b [dense] — 32L d=2560 32H (kv=32) d_ff=6912 vocab=50304.

StableLM-3B-4E1T: LayerNorm, SwiGLU FFN, partial rotary (25%).
[hf:stabilityai/stablelm-3b-4e1t; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304, norm="layernorm", act="silu", gated_ffn=True,
    rope_pct=0.25, rope_base=10_000.0,
    grad_accum=4,
)
