"""olmo-1b [dense] — 16L d=2048 16H (kv=16) d_ff=8192 vocab=50304.

OLMo's distinguishing choice: NON-PARAMETRIC LayerNorm (no learnable
affine), SwiGLU, full rotary, untied embeddings. [arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, norm="nonparam_ln", act="silu", gated_ffn=True,
    rope_pct=1.0,
    grad_accum=2,
)
