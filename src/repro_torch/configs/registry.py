"""Architecture registry (counterpart of ``repro/configs/registry.py``):
every architecture of the reference, in its order, the reduced smoke
variants, and the dry-run's cells and input specs (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).CONFIG


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced smoke variant: same family wiring, tiny dims, float32."""
    kv_ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_heads = 4
    ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=32,
                              slstm_every=2)
    moe = dataclasses.replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
                              top_k=min(cfg.moe.top_k, 2))
    approx = dataclasses.replace(cfg.approx, n_approx=2, d_hidden=32)
    if cfg.family == "ssm":
        n_layers, attn_every = 4, 0
    elif cfg.family == "hybrid":
        n_layers, attn_every = 4, 2
    else:
        n_layers, attn_every = 2, 0
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=64, n_heads=n_heads,
        n_kv_heads=max(1, n_heads // kv_ratio), head_dim=16,
        d_ff=128 if cfg.d_ff else 0, vocab=512,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        attn_every=attn_every, ssm=ssm, moe=moe, approx=approx,
        param_dtype="float32", act_dtype="float32", remat=False,
        q_block=32, kv_block=32)


# ---------------------------------------------------------------------------
# Dry-run cells and input specs (fake tensors: no allocation)
# ---------------------------------------------------------------------------

def full_attention_only(cfg: ModelConfig) -> bool:
    """True when the arch has no sub-quadratic path (long_500k is skipped)."""
    return cfg.family in ("dense", "moe", "audio", "vlm") \
        and not cfg.sliding_window


def cells(arch: str):
    """The (shape, step-kind) cells assigned to an arch, honoring skips."""
    cfg = get_config(arch)
    return [sh for name, sh in SHAPES.items()
            if not (name == "long_500k" and full_attention_only(cfg))]


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                device=None) -> dict:
    """Stand-ins for every model input of one cell, made under the
    caller's ``FakeTensorMode`` (so nothing is allocated) on ``device``
    (default ``cuda``: a fake tensor needs no card).

    train:   {"inputs", "labels"}
    prefill: {"inputs"}
    decode:  {"inputs", "cache"}: one new token against a ``seq_len``
             cache, ``models.model.init_cache(cfg, b, seq_len)``'s.
    Token inputs are int32 (B, n); embedding-input archs get (B, n,
    d_model) in the activation dtype."""
    dev = torch.device("cuda" if device is None else device)
    b, s = shape.global_batch, shape.seq_len

    def inp(n):
        if cfg.input_mode == "embeddings":
            return torch.empty((b, n, cfg.d_model), dtype=cfg.adtype,
                               device=dev)
        return torch.empty((b, n), dtype=torch.int32, device=dev)

    if shape.kind == "train":
        return {"inputs": inp(s),
                "labels": torch.empty((b, s), dtype=torch.int32,
                                      device=dev)}
    if shape.kind == "prefill":
        return {"inputs": inp(s)}
    from repro_torch.models.model import init_cache    # keeps this light
    return {"inputs": inp(1), "cache": init_cache(cfg, b, s, device=dev)}
