"""Declarative sharding rules: parameters, caches and batches ->
PartitionSpecs (counterpart of ``repro/sharding/rules.py``).

Pure Python over shapes: nothing here touches a device or a process
group, so the rules run on any shape-only model (``device="meta"``) and
on a duck-typed mesh (anything with ``axis_names`` and ``devices.shape``).

Scheme: the mesh has axes ("data", "model"), plus a leading pure-DP "pod"
axis in the multi-pod mesh.  Parameters are tensor-parallel over "model"
on their widest semantically shardable dim and FSDP-sharded over "data"
on a complementary dim.  Divisibility is checked per dim; a dim that does
not divide falls back to replication, recorded in a ``ShardingReport``.

  embed.tok        (V, d)        -> P(model, None)      vocab-parallel
  embed.unembed    (d, V)        -> P(None, model)
  attn wq/wk/wv    (d, H*hd)     -> P(data, model)      head-parallel
  attn wo          (H*hd, d)     -> P(model, data)
  ffn w_in/w_gate  (d, f)        -> P(data, model)      Megatron column
  ffn w_out        (f, d)        -> P(model, data)      Megatron row
  moe w_*          (E, d, f)     -> P(model, data, None) when E % |model|
                                    else P(None, data, model)
  approximators, routers, the tick router, biases and norms: replicated

The reference stacks layers, so its specs carry one or two leading
``None``s for the scan dims.  The port keeps one tensor per layer
(``blocks.<i>.attn.wq``), and its specs are the reference's with those
leading ``None``s dropped.  A ``ShardingReport`` records each stacked
leaf's fallback once, under the reference's path (``blocks/attn/wq``), in
the reference's order.

Caches: KV (L, B, S, KV, hd): batch over data when divisible, else
sequence over data; kv heads over model when divisible, else head_dim.
A paged pool replicates its pages over data.  SSM states: heads over
model, batch over data.
"""
from __future__ import annotations

import math


class P(tuple):
    """A PartitionSpec: one entry per dim, each None, an axis name or a
    tuple of axis names.  A 1-tuple normalizes to its one name, as
    ``jax.sharding.PartitionSpec`` does, so ``P(("data",), None) ==
    P("data", None)``."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = p[0] if len(p) == 1 else tuple(p)
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape))[name]


def _dp_axes(mesh):
    """The data-parallel meta-axis: ("pod", "data") multi-pod, else
    ("data",)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_axes(mesh):
    """Public alias of the DP meta-axis tuple (the dispatch engine, the
    serve context and the tests use it)."""
    return _dp_axes(mesh)


def _dp_size(mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in _dp_axes(mesh))


def _fits(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


class ShardingReport:
    """Collects which rules fell back to replication."""

    def __init__(self):
        self.fallbacks: list[str] = []

    def fallback(self, path: str, why: str):
        self.fallbacks.append(f"{path}: {why}")


def _spec2d(mesh, path, shape, col_model: bool, report) -> P:
    """Rule for a 2D matmul weight.  ``col_model`` shards the LAST dim
    over model (column-parallel), else the first; the complementary dim
    FSDPs over data.  Falls back per dim on divisibility."""
    md = _axis_size(mesh, "model")
    dp = _dp_size(mesh)
    rows, cols = shape[-2], shape[-1]
    if col_model:
        model_dim, data_dim = cols, rows
        spec = [_dp_axes(mesh) if _fits(rows, dp) else None,
                "model" if _fits(cols, md) else None]
    else:
        model_dim, data_dim = rows, cols
        spec = ["model" if _fits(rows, md) else None,
                _dp_axes(mesh) if _fits(cols, dp) else None]
    if not _fits(model_dim, md):
        report.fallback(path, f"model dim {model_dim} % {md} != 0")
    if not _fits(data_dim, dp):
        report.fallback(path, f"data dim {data_dim} % {dp} != 0")
    return P(*spec)


# param names that are column-parallel (last dim over model)
_COL = ("wq", "wk", "wv", "w_in", "w_gate", "w_up", "w_x", "w_xz", "w_bc",
        "w_q", "w_k", "w_v", "w_z", "unembed", "a_w1", "router", "w_if",
        "w_dt")
# row-parallel (first matmul dim over model)
_ROW = ("wo", "w_out", "w_down", "a_w2", "tok")


def _lead(path: str) -> int:
    """The reference's stacked scan dims of a leaf under ``path``."""
    if path.startswith(("mlstm/", "mamba/")):
        return 2
    return 1 if path.startswith(("blocks/", "slstm/")) else 0


def _param_rule(mesh, path: str, shape, report) -> P:
    """The spec of one per-layer tensor of shape ``shape`` under the
    reference path ``path`` (the reference's rule with its scan dims
    dropped)."""
    name = path.split("/")[-1]
    nd = len(shape)
    md = _axis_size(mesh, "model")
    # embedding tables: vocab-TP only (no FSDP on the feature dim)
    if name == "tok":
        return P("model" if _fits(shape[0], md) else None, None)
    if name == "unembed":
        return P(None, "model" if _fits(shape[1], md) else None)
    # the ApproxFFN's approximators and router and the tick-router head
    # are tiny: replicated (TP would only buy per-layer all-reduces)
    if "approx/" in path and name in ("a_w1", "a_w2", "router", "a_b1",
                                      "a_b2"):
        return P(*([None] * nd))
    if name == "tick_router":
        return P(*([None] * nd))
    if nd <= 1:
        return P()                      # biases, norms, scalars
    if name in ("w_in", "w_gate", "w_out") and nd == 3:
        # MoE expert stacks (E, d, f) / (E, f, d): EP over model
        e = shape[0]
        if _fits(e, md):
            return P("model",
                     _dp_axes(mesh) if _fits(shape[1], _dp_size(mesh))
                     else None, None)
        report.fallback(path, f"EP: {e} experts % {md} != 0 -> "
                              "TP-in-expert")
        return P(None, *_spec2d(mesh, path, shape, name != "w_out", report))
    if name in ("a_w1", "a_w2", "w_h") and nd == 3:
        # stacked approximators / the sLSTM's per-head recurrent weights
        return P(None, *_spec2d(mesh, path, shape, name != "a_w2", report))
    if nd == 2:
        if name in _COL:
            return _spec2d(mesh, path, shape, True, report)
        if name in _ROW:
            return _spec2d(mesh, path, shape, False, report)
        # unknown 2D param: the larger dim over model when it divides
        return _spec2d(mesh, path, shape, shape[1] >= shape[0], report)
    report.fallback(path, f"no rule for ndim={nd + _lead(path)}; replicated")
    return P(*([None] * nd))


def _ref_path(name: str) -> str:
    """A port parameter name as the reference's pytree path: the layer
    and group indices dropped (``blocks.3.attn.wq`` -> ``blocks/attn/wq``)."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _named_shapes(params) -> dict:
    """{name: shape} of an ``nn.Module``'s parameters or of a mapping of
    names to tensors (or shapes)."""
    items = params.named_parameters() if hasattr(params, "named_parameters") \
        else params.items()
    return {k: tuple(getattr(v, "shape", v)) for k, v in items}


def param_pspecs(mesh, params) -> tuple[dict, ShardingReport]:
    """{parameter name: P} for a model (or a name -> tensor mapping),
    and the report.  Each stacked leaf's rule runs once, in the
    reference's leaf order, so the report equals the reference's."""
    report = ShardingReport()
    shapes = _named_shapes(params)
    rule = {}
    for path in sorted({_ref_path(k) for k in shapes},
                       key=lambda p: tuple(p.split("/"))):
        shape = next(s for k, s in shapes.items() if _ref_path(k) == path)
        rule[path] = _param_rule(mesh, path, shape, report)
    return {k: rule[_ref_path(k)] for k in shapes}, report


def state_pspecs(mesh, state) -> tuple[dict, ShardingReport]:
    """A train state {"params", "opt": {"m", "v"}, "step"}: the optimizer
    moments shard exactly like their parameters (FSDP)."""
    pspecs, report = param_pspecs(mesh, state["params"])
    return {"params": pspecs, "opt": {k: dict(pspecs) for k in state["opt"]},
            "step": P()}, report


# ---------------------------------------------------------------------------
# Specs of the serving dispatch paths: the contracts the sharded serve code
# is written against (row-shaped values over the data axes, counts and
# weights replicated).
# ---------------------------------------------------------------------------

def shard_capacity(t_local: int, frac: float, *, slack: float = 1.0) -> int:
    """Per-shard capacity for a capacity fraction of a row-sharded batch:
    ``frac * t_local`` rows over-provisioned by ``slack``, clamped to
    ``[1, t_local]`` (capacity past t_local can never fill).  The engine
    dispatches per data shard, so a class hot on one shard drops rows even
    when another shard has slack; ``slack > 1`` buys headroom against
    that skew."""
    return max(min(int(t_local * frac * slack), t_local), 1)


def mcma_dispatch_specs(mesh, *, data_axes=None, with_mask: bool = False,
                        with_tier: bool = False,
                        with_residency: bool = False) -> dict:
    """Specs of ``runtime/dispatch.mcma_dispatch_sharded`` on flat (T, d)
    row batches: x, logits and y row-sharded over the data axes; the exact
    params and the approximator stacks replicated; the stats replicated
    (all-reduced inside).  ``with_mask`` appends the (T,) row mask,
    ``with_tier`` the (T,) tier vector (row-sharded) and the (n_tiers,)
    margins (replicated), ``with_residency`` the (n_resident,) residency
    vector (replicated)."""
    dp = tuple(data_axes) if data_axes is not None else _dp_axes(mesh)
    row = P(dp, None)
    ins = (row, row, P(), P(None, None, None), P(None, None),
           P(None, None, None), P(None, None))
    if with_mask:
        ins = ins + (P(dp),)
    if with_tier:
        ins = ins + (P(dp), P(None))
    if with_residency:
        ins = ins + (P(None),)
    return {"in": ins, "out": (row, P())}


def dispatch_plan_specs(mesh, like=None, *, data_axes=None, n_approx=None,
                        exact_cap=None, invoke_cap=None, block_t=None,
                        backend=None, n_tiers=1, library_size=0):
    """A ``runtime/dispatch.DispatchPlan`` of specs for a plan built per
    data shard: the row-shaped fields (shard-local indices) and
    ``tile_cls`` row-sharded, the all-reduced count fields replicated.
    ``like`` copies an existing plan's static metadata; else give it."""
    from repro_torch.runtime.dispatch import DispatchPlan
    if like is not None:
        (n_approx, exact_cap, invoke_cap, block_t, backend, n_tiers,
         library_size) = (like.n_approx, like.exact_cap, like.invoke_cap,
                          like.block_t, like.backend, like.n_tiers,
                          like.library_size)
    dp = tuple(data_axes) if data_axes is not None else _dp_axes(mesh)
    row, rep = P(dp), P()
    return DispatchPlan(cls=row, rank=row, eff=row, order=row, pos=row,
                        tile_cls=row, exact_keep=row, exact_slot=row,
                        counts=rep, dispatched=rep, t_total=rep,
                        executed=rep, tier=row, tier_counts=rep,
                        tier_dispatched=rep, lib_counts=rep,
                        off_set_rows=rep, n_approx=n_approx,
                        exact_cap=exact_cap, invoke_cap=invoke_cap,
                        block_t=block_t, backend=backend, n_tiers=n_tiers,
                        library_size=library_size)


def approx_serve_specs(mesh, *, gated: bool, plan=None,
                       with_tier: bool = False, mask2d: bool = False,
                       with_residency: bool = False) -> dict:
    """Specs of the sharded ApproxFFN serve path (models/approx_ffn.py):
    the exact FFN's weights Megatron-TP over "model" and FSDP over the
    data axes; router and approximators replicated; tokens batch-sharded
    with their (B,) slot mask (``mask2d``: the (B, S) token mask of a
    prefill chunk, whose ``P(dp)`` leaves the token dim whole: a spec
    shorter than its tensor replicates the rest); stats replicated.
    ``with_tier`` appends the (B,) tiers and the replicated margins;
    ``plan`` (tick scope) replaces the mask and stats with the plan: in
    (weights, x, plan), out y.  ``with_residency`` appends the replicated
    residency vector."""
    dp = _dp_axes(mesh)
    ffn = {"w_in": P(dp, "model"), "w_out": P("model", dp)}
    if gated:
        ffn["w_gate"] = P(dp, "model")
    weights = {"ffn": ffn, "router": P(None, None),
               "a_w1": P(None, None, None), "a_b1": P(None, None),
               "a_w2": P(None, None, None), "a_b2": P(None, None)}
    if plan is not None:
        return {"in": (weights, P(dp, None, None),
                       dispatch_plan_specs(mesh, plan, data_axes=dp)),
                "out": P(dp, None, None)}
    ins = (weights, P(dp, None, None), P(dp))
    if with_tier:
        ins = ins + (P(dp), P(None))
    if with_residency:
        ins = ins + (P(None),)
    return {"in": ins, "out": (P(dp, None, None), P())}


def moe_manual_specs(mesh, *, gated: bool) -> dict:
    """Specs of the expert-parallel MoE path (``models/moe.
    _moe_fwd_manual``): expert stacks EP over "model" and FSDP over data,
    the router TP over both, tokens batch-sharded, the aux loss
    replicated.  Where E divides over "model" these are the specs
    ``param_pspecs`` gives the MoE's leaves, which the port's parameters
    carry (``_pspec``) and the manual path gathers by."""
    dp = _dp_axes(mesh)
    weights = {"router": P(dp, "model"),
               "w_in": P("model", dp, None), "w_out": P("model", dp, None)}
    if gated:
        weights["w_gate"] = P("model", dp, None)
    return {"in": (weights, P(dp, None, None)),
            "out": (P(dp, None, None), P())}


def batch_pspec(mesh, arr_or_shape) -> P:
    """Inputs and labels: batch over the DP meta-axis (embeddings also
    feature-sharded over model); sequence-sharded when the batch does not
    divide (a B = 1 long decode)."""
    shape = tuple(getattr(arr_or_shape, "shape", arr_or_shape))
    dp = _dp_axes(mesh)
    if _fits(shape[0], _dp_size(mesh)):
        spec = [dp] + [None] * (len(shape) - 1)
    elif len(shape) >= 2 and _fits(shape[1], _dp_size(mesh)):
        spec = [None, dp] + [None] * (len(shape) - 2)
    else:
        spec = [None] * len(shape)
    if len(shape) == 3 and _fits(shape[-1], _axis_size(mesh, "model")):
        spec[-1] = "model"
    return P(*spec)


def _cache_rule(mesh, path: str, shape, *, paged: bool = False) -> P:
    name = path.split("/")[-1]
    md = _axis_size(mesh, "model")
    dp = _dp_size(mesh)
    dpa = _dp_axes(mesh)
    if name == "pos" or len(shape) <= 1:
        return P()
    if name == "block_table":
        # (B, n_pp): rides with the batch like the rows it indexes
        return P(dpa if _fits(shape[0], dp) else None, None)
    if name in ("k", "v") and paged:
        # paged pool (L, n_pages, page_size, KV, hd): pages replicate over
        # data (any data shard's slot may hold any page); heads (else
        # head_dim) over model as in the dense cache
        spec = [None] * 5
        if _fits(shape[3], md):
            spec[3] = "model"
        elif _fits(shape[4], md):
            spec[4] = "model"
        return P(*spec)
    if name in ("k", "v"):
        # (L, B, S, KV, hd) or (G, B, S, KV, hd)
        _, b, s, kv, hd = shape
        spec = [None, dpa if _fits(b, dp) else None, None, None, None]
        if spec[1] is None and _fits(s, dp):
            spec[2] = dpa                                # context-parallel
        if _fits(kv, md):
            spec[3] = "model"
        elif _fits(hd, md):
            spec[4] = "model"
        return P(*spec)
    # SSM / mLSTM / sLSTM states (G[, P], B, H, ...)
    lead = 2 if path.startswith(("mlstm/", "mamba/")) else 1
    spec = [None] * len(shape)
    if _fits(shape[lead], dp):
        spec[lead] = dpa
    if len(shape) > lead + 1 and _fits(shape[lead + 1], md):
        spec[lead + 1] = "model"
    return P(*spec)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def cache_pspecs(mesh, cache) -> dict:
    """A decode cache's specs, as a dict of the cache's nesting."""
    paged = any(k.split("/")[-1] == "block_table" for k, _ in _leaves(cache))

    def rebuild(prefix, tree):
        return {k: rebuild(f"{prefix}{k}/", v) if isinstance(v, dict)
                else _cache_rule(mesh, f"{prefix}{k}",
                                 tuple(getattr(v, "shape", v)), paged=paged)
                for k, v in tree.items()}
    return rebuild("", cache)
