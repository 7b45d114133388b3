"""moonshot-v1-16b-a3b [moe] — 48L d=2048 16H (kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 (Moonlight-16B-A3B).
[hf:moonshotai/Moonlight-16B-A3B; hf]

The MoE router is itself a multiclass dispatcher: the MoE takes the
FFN's place, so the ApproxFFN and the tick-router head are never built
on this architecture (no double routing).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, norm="rmsnorm", act="silu", gated_ffn=True,
    moe=MoEConfig(n_experts=64, top_k=6, capacity_factor=1.25),
    grad_accum=4,
)
