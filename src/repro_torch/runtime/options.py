"""The serving API: ``ServeOptions`` (counterpart of
``repro/runtime/options.py``).

The same fields, names and defaults as the reference, so options pair
one-to-one.  ``DecodeServer`` serves every field but those of features
not ported yet, which raise ``NotImplementedError`` there, naming the
ROADMAP queue 1 item that ports them:

    qos_tiers, qos_app   item 6b (QoS tiers, with apps/)
    library, autotune    item 6c (library residency, runtime/autotune.py;
                         ``LibrarySpec`` comes with it)
    mesh                 item 10 (multiple devices)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Everything a ``DecodeServer`` deployment decides at serve time.

    batching:    batch, max_len, eos, greedy, seed
    dispatch:    use_mcma_dispatch, backend ("pallas" = switched CUDA
                 kernel, "pallas_fused" = fused CUDA kernel, "xla" =
                 eager oracle, None = "pallas"), route_scope, mesh
    autotune:    autotune, drop_budget, autotune_kwargs
    QoS:         qos_tiers, qos_app, qos_margin_scale
    scheduling:  prefill_chunk, admission ("cost"/"fifo"),
                 overflow ("reject"/"trim"), aging
    memory:      kv_page_size (paged KV cache page length in tokens;
                 must divide max_len; 0 = the dense (batch, max_len)
                 layout), kv_pages (page-pool size; 0 = batch x
                 max_len / kv_page_size)
    library:     approximator-library residency
    """

    batch: int = 8
    max_len: int = 512
    eos: Optional[int] = None
    greedy: bool = True
    seed: int = 0
    use_mcma_dispatch: bool = False
    mesh: Any = None
    autotune: Any = None
    drop_budget: float = 0.05
    autotune_kwargs: Optional[dict] = None
    route_scope: Optional[str] = None
    qos_tiers: Any = None
    qos_app: Optional[str] = None
    qos_margin_scale: float = 4.0
    prefill_chunk: int = 0
    admission: str = "cost"
    overflow: str = "reject"
    aging: float = 0.05
    kv_page_size: int = 0
    kv_pages: int = 0
    backend: Optional[str] = None
    library: Any = None

    @classmethod
    def from_args(cls, args, **overrides) -> "ServeOptions":
        """Build from an argparse namespace produced by
        ``runtime/cli.add_serve_options``; ``overrides`` win."""
        kw = {f: getattr(args, f) for f in
              ("batch", "max_len", "route_scope", "prefill_chunk",
               "admission", "overflow", "aging", "kv_page_size",
               "kv_pages", "backend", "seed")
              if hasattr(args, f)}
        if getattr(args, "mcma_dispatch", False):
            kw["use_mcma_dispatch"] = True
        kw.update(overrides)
        return cls(**kw)
