"""One file a model family: ``families/<family>.py``, found by the
configuration's ``family``.  A family file gives the plain reference and
the yardstick what differs between families:

  specs(cfg, k)           its parameters as (name, shape, kind, arg), the
                          kinds ``weights.draw`` knows (``k`` is
                          ``weights.dims(cfg)``), beside the embeddings, the
                          final norm and the tick router every family has;
  body(cfg, get, x, dec)  its layers in float32 on the embedded sequence
                          x (L, d), each MCMA FFN served by ``dec``;
  mcma_sites(cfg)         how many MCMA FFNs a token passes;
  token_flops(cfg, ctx)   the exact model's forward FLOP for one token over
                          ``ctx`` positions, without the LM head (affine in
                          ``ctx``).

A family file imports nothing of the port."""
from __future__ import annotations

import importlib


def family(cfg: dict):
    """The module of the configuration's family."""
    return importlib.import_module(f"h100_bench.families.{cfg['family']}")
