"""The serving API: ``ServeOptions`` and ``LibrarySpec`` (counterpart of
``repro/runtime/options.py``).

The same fields, names and defaults as the reference, so options pair
one-to-one.  ``DecodeServer`` serves every field; ``mesh`` (a
``launch/mesh.HostMesh``) serves the dense family SPMD, one process per
rank.

``LibrarySpec`` declares approximator-library residency: a library of
``library_size`` trained approximators of which ``n_resident`` occupy the
weight stacks at a time, with a ``ResidencyController``
(runtime/autotune.py) promoting and demoting library classes from the
served routed-per-class EMA.  The trained library size itself is
``ApproxConfig.library_size`` and must match.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class LibrarySpec:
    """Approximator-library residency policy (serve-time).

    library_size    trained approximators in the library (must equal
                    ``ApproxConfig.library_size`` of the checkpoint)
    n_resident      slots in the prepadded weight stacks — the classes
                    servable without a swap (becomes the serving
                    ``n_approx``; capacities are per-slot)
    promote_margin  promote the hottest off-set class over the coldest
                    resident when its routed-share EMA exceeds
                    ``promote_margin x`` the resident's (ratio hysteresis
                    — a borderline class doesn't thrash)
    demote_margin   absolute routed-share floor: a resident serving more
                    than this fraction of traffic is never demoted,
                    whatever is knocking
    observe_window  controller decides once per this many observed ticks
    cooldown        ticks after a swap before the next decision window
                    counts (lets the EMA re-converge on the new set)
    ema             smoothing factor for the routed-per-class shares
    start           initial resident library ids; () = the first
                    ``n_resident`` classes (library ids 0..n_resident-1)
    """

    library_size: int
    n_resident: int
    promote_margin: float = 1.5
    demote_margin: float = 0.25
    observe_window: int = 8
    cooldown: int = 16
    ema: float = 0.3
    start: tuple = ()

    def __post_init__(self):
        assert self.n_resident >= 1, "need at least one resident slot"
        assert self.library_size >= self.n_resident, (
            f"library_size={self.library_size} must hold at least the "
            f"{self.n_resident} resident classes")
        assert self.promote_margin >= 1.0, \
            "promote_margin < 1 would thrash on noise"
        if self.start:
            assert len(self.start) == self.n_resident and \
                all(0 <= s < self.library_size for s in self.start), (
                    f"start={self.start} must name {self.n_resident} "
                    f"distinct library ids < {self.library_size}")

    def initial_residency(self) -> tuple:
        return tuple(self.start) if self.start \
            else tuple(range(self.n_resident))


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
    library:     a ``LibrarySpec`` enabling approximator-library
                 residency (None = every approximator resident)
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
    library: Optional[LibrarySpec] = None

    @classmethod
    def from_args(cls, args, **overrides) -> "ServeOptions":
        """Build from an argparse namespace produced by
        ``runtime/cli.add_serve_options`` (missing attributes keep their
        field defaults, so a surface may register only a subset of the
        shared flags).  ``overrides`` win over both.

        Applies the historic implication chain: ``--qos-app`` /
        ``--tier-bounds`` imply QoS; QoS / ``--autotune`` / a library
        imply the MCMA dispatch engine.
        """
        kw = {}
        for f in ("batch", "max_len", "drop_budget", "route_scope",
                  "qos_app", "prefill_chunk", "admission", "overflow",
                  "aging", "kv_page_size", "kv_pages", "backend", "seed",
                  "greedy", "eos"):
            if hasattr(args, f):
                kw[f] = getattr(args, f)
        if getattr(args, "autotune", False):
            kw["autotune"] = True
        if getattr(args, "tier_bounds", None):
            tb = args.tier_bounds
            kw["qos_tiers"] = tuple(float(b) for b in tb.split(",")) \
                if isinstance(tb, str) else tuple(tb)
        elif getattr(args, "qos", False) or kw.get("qos_app"):
            kw["qos_tiers"] = True
        if getattr(args, "library_size", 0):
            kw["library"] = LibrarySpec(
                library_size=args.library_size,
                n_resident=getattr(args, "n_resident", 0)
                or min(4, args.library_size))
        kw.update(overrides)
        if kw.get("autotune") or kw.get("qos_tiers") or kw.get("library"):
            kw.setdefault("use_mcma_dispatch", True)
        elif getattr(args, "mcma_dispatch", False):
            kw["use_mcma_dispatch"] = True
        return cls(**kw)
