"""stablelm-1.6b [dense] — 24L d=2048 32H (kv=32) d_ff=5632 vocab=100352.

StableLM-2-1.6B: LayerNorm (with bias), partial rotary 25%, qkv biases.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, norm="layernorm", act="silu", gated_ffn=True,
    rope_pct=0.25, qkv_bias=True,
    grad_accum=2,
)
