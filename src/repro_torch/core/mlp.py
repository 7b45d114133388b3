"""Small-MLP topology spec (counterpart of ``repro/core/mlp.py``, only
``MLPSpec`` so far: the apps registry names its approximator and
classifier topologies with it).  The trainer (RMSprop full-batch
``train_mlp``) waits for the paper pipeline, ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Topology spec: ``sizes=(6, 8, 1)`` means 6->8->1."""

    sizes: tuple
    hidden_act: str = "tanh"
    out_act: str = "linear"      # regression output by default

    @staticmethod
    def parse(topo: str, **kw) -> "MLPSpec":
        """Parse a paper-style topology string like ``"6->8->1"``."""
        sizes = tuple(int(t) for t in topo.replace(" ", "").split("->"))
        return MLPSpec(sizes=sizes, **kw)

    @property
    def n_layers(self) -> int:
        return len(self.sizes) - 1

    @property
    def n_macs(self) -> int:
        """Multiply-accumulates per forward pass (the NPU cost model's)."""
        return int(sum(a * b for a, b in zip(self.sizes[:-1], self.sizes[1:])))

    @property
    def n_params(self) -> int:
        return int(sum(a * b + b
                       for a, b in zip(self.sizes[:-1], self.sizes[1:])))
