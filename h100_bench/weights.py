"""The benchmark's weights: every parameter of a configuration drawn on the
device from the run's seed, by name, in the dtype it is served in.

Names are the parameters' paths (``blocks.3.attn.wq``), shapes the
logical ones (the approximator stacks ``(n, d, d_hidden)`` without the
serving layout's padding or pseudo-class).  Random draws come from one
``torch.Generator`` in a few large calls (chunks of up to 2**30 values),
so the same seed gives the same weights wherever they are drawn again:
the harness loads them into the program, and the reference draws them
anew after the program's state is freed.  Nothing here imports the port.
"""
from __future__ import annotations

import math

import torch

from h100_bench.families import family

CHUNK = 1 << 30


def dims(cfg: dict) -> dict:
    d, nh, nkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = d // nh
    a = cfg["approx"]
    return dict(d=d, hd=hd, nh=nh, nkv=nkv, f=cfg["d_ff"], v=cfg["vocab"],
                n=a.get("library_size") or a["n_approx"], h=a["d_hidden"])


def block(prefix: str, k: dict) -> list:
    """(name, shape, kind, arg) of one attention + MCMA FFN block."""
    d, hd, f, n, h = k["d"], k["hd"], k["f"], k["n"], k["h"]
    s = d ** -0.5
    return [
        (f"{prefix}.ln1.scale", (d,), "around1", 0.05),
        (f"{prefix}.attn.wq", (d, k["nh"] * hd), "normal", s),
        (f"{prefix}.attn.wk", (d, k["nkv"] * hd), "normal", s),
        (f"{prefix}.attn.wv", (d, k["nkv"] * hd), "normal", s),
        (f"{prefix}.attn.wo", (k["nh"] * hd, d), "normal",
         (k["nh"] * hd) ** -0.5),
        (f"{prefix}.ln2.scale", (d,), "around1", 0.05),
        (f"{prefix}.approx.ffn.w_in", (d, f), "normal", s),
        (f"{prefix}.approx.ffn.w_gate", (d, f), "normal", s),
        (f"{prefix}.approx.ffn.w_out", (f, d), "normal", f ** -0.5),
        (f"{prefix}.approx.router", (d, n + 1), "normal", s),
        (f"{prefix}.approx.a_w1", (n, d, h), "normal", s),
        (f"{prefix}.approx.a_b1", (n, h), "normal", 0.02),
        (f"{prefix}.approx.a_w2", (n, h, d), "normal", h ** -0.5),
        (f"{prefix}.approx.a_b2", (n, d), "normal", 0.02),
    ]


def specs(cfg: dict) -> list:
    """Every parameter as (name, shape, kind, arg): kind "normal" draws
    N(0, 1) * arg, "around1" 1 + N(0, 1) * arg.  The family's own
    parameters come from its file (``families/<family>.py``)."""
    k = dims(cfg)
    d = k["d"]
    out = [("embed.tok", (k["v"], d), "normal", 0.02),
           ("embed.unembed", (d, k["v"]), "normal", 0.02),
           ("ln_f.scale", (d,), "around1", 0.05)]
    out += family(cfg).specs(cfg, k)
    # the tick router's logits over the 0.02-scaled embeddings at unit
    # scale, the scale the QoS tiers' margins are set against
    out.append(("tick_router", (d, k["n"] + 1), "normal",
                1.0 / (0.02 * d ** 0.5)))
    return out


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: tensor} of every parameter, drawn from ``seed`` on
    ``device`` in ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sp = specs(cfg)
    # pack the random tensors into chunks in spec order, one draw a chunk
    chunks, fill, where = [], 0, {}
    for name, shape, _, _ in sp:
        n = math.prod(shape)
        if not chunks or fill + n > CHUNK:
            chunks.append([])
            fill = 0
        where[name] = (len(chunks) - 1, fill)
        chunks[-1].append(n)
        fill += n
    bufs = [torch.randn(sum(c), generator=gen, device=device, dtype=dtype)
            for c in chunks]
    out = {}
    for name, shape, kind, arg in sp:
        if kind not in ("normal", "around1"):
            raise ValueError(f"{name}: unknown kind {kind!r}")
        c, off = where[name]
        t = bufs[c][off:off + math.prod(shape)].view(shape)
        t.mul_(arg)
        if kind == "around1":
            t.add_(1.0)
        out[name] = t
    return out
