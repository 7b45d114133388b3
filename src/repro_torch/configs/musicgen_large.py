"""musicgen-large [audio] — 48L d=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only transformer over EnCodec tokens; the EnCodec frontend is a
STUB (the model takes precomputed frame embeddings, per the
assignment).  LayerNorm + GELU (non-gated) per the MusicGen/AudioCraft
decoder. [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=2048, norm="layernorm", act="gelu", gated_ffn=False,
    input_mode="embeddings",
    grad_accum=4,
)
