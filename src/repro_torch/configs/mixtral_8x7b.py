"""mixtral-8x7b [moe] — 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, norm="rmsnorm", act="silu", gated_ffn=True,
    sliding_window=4096, rope_base=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
    grad_accum=8,
)
