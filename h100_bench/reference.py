"""The plain reference: the configurations' forward pass in float32 PyTorch,
one sequence at a time, with no cache, batching or kernel.

What every family shares is here: the embeddings, the final RMSNorm and
untied LM head, the tick router, and the attention + MCMA block (GQA with
RoPE over every head dim, causal softmax attention, a SwiGLU exact FFN).
A family's layers are its own file, ``families/<family>.py``.
The MCMA FFN serves each position by a decision worked out by
``check.decisions``: the exact FFN, one of the tanh approximators, or
nothing (a row over its class's capacity adds zero; the residual carries
it).  ``router_logits`` are what the tick router decides each token by.

Weights come as {name: tensor} from ``weights.draw`` (the names and
logical shapes there) and are read through ``get(name)``, which gives
them in float32 (or, for the control, as a lower precision maps them).
TF32 is off.  Nothing here imports the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-6


def float32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def rope(x, positions, base):
    """x (L, H, hd), rotated pairwise: (x[2i], x[2i+1]) by positions *
    base^(-2i/hd)."""
    hd = x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd))
    ang = positions.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       -1).reshape(x.shape)


def attention(cfg, get, p, x):
    """Causal GQA self-attention over the whole sequence x (L, d)."""
    L, d = x.shape
    nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = d // nh
    pos = torch.arange(L, device=x.device)
    q = rope((x @ get(f"{p}.wq")).view(L, nh, hd), pos, cfg["rope_base"])
    k = rope((x @ get(f"{p}.wk")).view(L, nkv, hd), pos, cfg["rope_base"])
    v = (x @ get(f"{p}.wv")).view(L, nkv, hd)
    rep = nh // nkv
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    s = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool,
                                  device=x.device).tril(), float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    return o.reshape(L, nh * hd) @ get(f"{p}.wo")


def mcma(cfg, get, p, x, decision):
    """The MCMA FFN on x (L, d): decision[t] = 0 exact, c >= 1 the c-th
    approximator, -1 nothing."""
    out = torch.zeros_like(x)
    ex = decision == 0
    if ex.any():
        xe = x[ex]
        h = F.silu(xe @ get(f"{p}.ffn.w_gate")) * (xe @ get(f"{p}.ffn.w_in"))
        out[ex] = h @ get(f"{p}.ffn.w_out")
    w1, b1 = get(f"{p}.a_w1"), get(f"{p}.a_b1")
    w2, b2 = get(f"{p}.a_w2"), get(f"{p}.a_b2")
    for c in range(w1.shape[0]):
        m = decision == c + 1
        if m.any():
            out[m] = torch.tanh(x[m] @ w1[c] + b1[c]) @ w2[c] + b2[c]
    return out


def attn_mcma_block(cfg, get, p, x, decision):
    x = x + attention(cfg, get, f"{p}.attn", rmsnorm(x, get(f"{p}.ln1.scale")))
    return x + mcma(cfg, get, f"{p}.approx", rmsnorm(x, get(f"{p}.ln2.scale")),
                    decision)


def logits(cfg, get, tokens, decision, at):
    """Logits (len(at), vocab) at positions ``at`` of the sequence
    ``tokens`` (L,), each position's MCMA FFN served by ``decision``."""
    from h100_bench.families import family
    x = get("embed.tok")[tokens.long()]
    x = family(cfg).body(cfg, get, x, decision)
    x = rmsnorm(x[at], get("ln_f.scale"))
    return x @ get("embed.unembed")


def router_logits(cfg, get, tokens) -> torch.Tensor:
    """The tick router's logits for each token id over its embedding,
    rounded to the precision the configuration serves them in (a bf16
    product rounds its output to bf16), so that a tie resolves as it is
    served; float32.  Column 0 is the exact class.  The class is their
    argmax (first of equals), after any QoS margin on column 0."""
    x = get("embed.tok")[tokens.long()]
    lg = x @ get("tick_router")
    return lg.to(getattr(torch, cfg["act_dtype"])).float()
