"""internvl2-76b [vlm] — 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternVL2-Llama3-76B language backbone (Llama-3-70B shape); the InternViT
frontend is a STUB (the model takes precomputed patch embeddings,
per the assignment). [arXiv:2404.16821; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, norm="rmsnorm", act="silu", gated_ffn=True,
    rope_base=500_000.0, input_mode="embeddings",
    grad_accum=16,
    act_shard="fp",
)
