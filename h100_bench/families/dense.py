"""The dense family (internlm2): L x [x += attn(rmsnorm(x));
x += mcma(rmsnorm(x))], GQA with RoPE over every head dim, causal softmax
attention and a SwiGLU exact FFN beside the MCMA approximators."""
from __future__ import annotations

from h100_bench import reference as R
from h100_bench import weights as W


def specs(cfg: dict, k: dict) -> list:
    out = []
    for i in range(cfg["n_layers"]):
        out += W.block(f"blocks.{i}", k)
    return out


def body(cfg: dict, get, x, decision):
    for i in range(cfg["n_layers"]):
        x = R.attn_mcma_block(cfg, get, f"blocks.{i}", x, decision)
    return x


def mcma_sites(cfg: dict) -> int:
    return cfg["n_layers"]


def token_flops(cfg: dict, context: int) -> int:
    """Every projection, the exact SwiGLU FFN whatever the dispatch served,
    and attention over ``context`` positions, in every layer."""
    d, f = cfg["d_model"], cfg["d_ff"]
    nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = d // nh
    proj = 2 * d * (nh + 2 * nkv) * hd + 2 * nh * hd * d
    return cfg["n_layers"] * (proj + 2 * 3 * d * f + 4 * context * nh * hd)
