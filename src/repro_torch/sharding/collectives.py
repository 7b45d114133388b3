"""Collectives over named mesh axes: the port's ``jax.lax.psum`` and
``all_gather`` (no reference counterpart: in the reference they are
primitives of ``shard_map``).

Every collective of the mesh serving and training paths goes through
here, so the backend is one choice (``launch/mesh.HostMesh``): gloo, or
NCCL where each rank has a card of its own.  Gloo runs on host memory.
Ranks of one host that share an exchange arena (``use_host_arena``, given
by ``launch/mesh.spawn_world``) move a gather's payload through it
instead of gloo's loopback TCP, in rounds of at most a slot: each rank
writes its part into its own slot, a gloo barrier, each reads its
group's slots, a second barrier (so no slot is rewritten before its
readers are done).  Otherwise a CUDA tensor under gloo is staged through
a pinned host buffer and back.  Either way a CUDA tensor's trip through
the host is copies the host waits for, counted in ``COUNTS["staged"]``
(and its bytes), and no rank's compute moves off its device.

``all_reduce_sum`` gathers the shards and adds them in rank order, so
every rank of the group holds the same bits whatever the backend's
reduction order, and the sum of int32 stats stays int32.  ``mesh=None``
takes the mesh of the enclosing ``sharding/activations`` context.  Over
an axis of size 1 nothing is sent.

The collectives that the model's forward calls are
``torch.autograd.Function``s, and their backward depends on who
consumes the result: ``all_gather`` (consumers replicated over the
axes, as the logits are) takes this rank's slice of the gradient;
``all_reduce_sum`` (a row-parallel output) passes the gradient on;
``copy_to_model`` (the identity on the replicated input of a
column-parallel projection) sums it over "model"; ``model_columns`` (a
replicated leaf cut to the rank's columns) gathers it whole;
``gather_for_split`` (a column-parallel output gathered whole for
consumers that each take another slice of it: a rank's heads of a
projection whose columns are not laid out by heads; over the data
axes, the keys of a sequence split over them) reduce-scatters it;
and ``unshard`` (FSDP) reduce-scatters it over the data axes, in one
collective as its forward gathers.  Their forward results are those of the plain collectives, bit for bit.  ``all_to_all`` and
``reduce_scatter`` (the serve paths' exchanges over a head_dim-split KV
cache) have no backward.

``WIRE`` counts, on every path (gloo, arena, staged, NCCL, the fake
backend of ``launch/dryrun.py``), each collective's calls and the bytes
one rank sends by kind, as the port's algorithms send them: a gather of
n parts of p bytes sends (n-1)·p; ``all_reduce_sum`` is such a gather
(then a sum in rank order), so it too sends (n-1)·p, where a ring
all-reduce sends 2(n-1)/n·p; a reduce-scatter (the exchange of an (n,
...) buffer of S bytes) sends (n-1)/n·S.  Beside them, ``ring_bytes``:
the ring model's bytes for the same call (all-reduce 2(n-1)/n·p,
all-gather and reduce-scatter and all-to-all as sent).  Counting
changes nothing that is sent.  ``observe_wire`` hands each call to an
observer with its group's ranks, and ``in_transport`` says whether the
running op belongs to a collective's transport (its host copies and
arena rounds), which ``launch/hlo_cost.py`` keeps out of the device
bytes.  On torch's fake backend (the dry run's world of 256 or 512
ranks in one process) nothing is sent, so nothing is moved: a gather's
every part is this rank's own tensor, an exchange returns what it was
given (the fake backend's own calls cost 2 ms a gather on fake tensors,
hours over a sweep).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.sharding.activations import current_mesh
from repro_torch.sharding.rules import dp_axes, param_pspecs

# launches of the collectives, and the host stagings and their bytes
COUNTS = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0,
          "all_to_all": 0, "gather_for_split": 0, "staged": 0,
          "staged_bytes": 0}
# calls, bytes sent by one rank, and the ring model's bytes, by kind
WIRE_KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
WIRE = {k: {"calls": 0, "bytes": 0, "ring_bytes": 0} for k in WIRE_KINDS}
_OBSERVERS: list = []
_TRANSPORT = [0]
_PINNED: dict = {}
# [shared uint8 arena, bytes a rank's slot, page-locked here yet]
_ARENA: list = []


def use_host_arena(arena: torch.Tensor, slot_bytes: int):
    """Move gathers through ``arena``, a uint8 CPU tensor in memory shared
    by every rank of the world: rank r's slot is bytes [r * slot_bytes,
    (r + 1) * slot_bytes).  Once CUDA is initialized a process page-locks
    the arena at its next exchange, so copies to and from the card run at
    the pinned rate."""
    _ARENA[:] = [arena, slot_bytes, False]


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0
    for w in WIRE.values():
        w.update(calls=0, bytes=0, ring_bytes=0)


@contextlib.contextmanager
def observe_wire(fn):
    """Within the block, ``fn(kind, nbytes, sent, ring, ranks)`` for
    every collective this rank calls: the bytes of its part (a gather or
    all-reduce) or of its send buffer (a reduce-scatter or all-to-all),
    the bytes it sends, the ring model's bytes, and the global ranks of
    its group."""
    _OBSERVERS.append(fn)
    try:
        yield
    finally:
        _OBSERVERS.remove(fn)


def in_transport() -> bool:
    """True while a collective moves its payload (the host copies, the
    arena rounds and the backend's calls of ``_gather_parts`` and
    ``_exchange``)."""
    return _TRANSPORT[0] > 0


@contextlib.contextmanager
def _transport():
    _TRANSPORT[0] += 1
    try:
        yield
    finally:
        _TRANSPORT[0] -= 1


def _wire(kind: str, nbytes: int, axes, mesh):
    """Count one collective over ``axes``: a gather or all-reduce of a
    part of ``nbytes``, or a reduce-scatter or all-to-all of an (n, ...)
    buffer of ``nbytes``."""
    n = mesh.size(axes)
    if kind in ("all_gather", "all_reduce"):
        sent = (n - 1) * nbytes
        ring = 2 * (n - 1) * nbytes / n if kind == "all_reduce" else sent
    else:
        sent = ring = (n - 1) * (nbytes // n)
    w = WIRE[kind]
    w["calls"] += 1
    w["bytes"] += sent
    w["ring_bytes"] += ring
    if _OBSERVERS:
        named = {axes} if isinstance(axes, str) else set(axes)
        ranks = mesh.group_ranks(tuple(a for a in mesh.axis_names
                                       if a in named))
        for fn in _OBSERVERS:
            fn(kind, nbytes, sent, ring, ranks)


def _mesh(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    assert mesh is not None, "a collective needs a mesh (pass one or run " \
        "inside sharding.activations.activation_sharding)"
    return mesh


def _pinned(dtype, numel: int, role: str) -> torch.Tensor:
    """A pinned host buffer per dtype, size and role, reused."""
    key = (dtype, numel, role)
    if key not in _PINNED:
        _PINNED[key] = torch.empty(numel, dtype=dtype, pin_memory=True)
    return _PINNED[key]


def _gather_parts(t: torch.Tensor, axes, mesh,
                  kind: str = "all_gather") -> list:
    """Every rank's ``t`` along ``axes``, in rank order, on ``t``'s
    device; this rank's own part is ``t`` itself.  Under gloo with an
    arena the parts move through it; else a CUDA tensor under gloo goes
    out through one pinned buffer and the other ranks' parts come back
    through another (copies the host waits for).  Counted in ``WIRE``
    as ``kind``."""
    _wire(kind, t.numel() * t.element_size(), axes, mesh)
    with _transport():
        return _gather_parts_moved(t, axes, mesh)


def _gather_parts_moved(t: torch.Tensor, axes, mesh) -> list:
    n, group = mesh.size(axes), mesh.group(axes)
    if mesh.backend == "fake":
        return [t] * n
    if mesh.backend == "gloo" and _ARENA:
        return _arena_gather(t, axes, mesh)
    if not (t.is_cuda and mesh.backend == "gloo"):
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return parts
    src = _pinned(t.dtype, t.numel(), "in").view(t.shape)
    src.copy_(t)
    dst = _pinned(t.dtype, t.numel() * n, "out").view(n, *t.shape)
    dist.all_gather(list(dst.unbind(0)), src, group=group)
    COUNTS["staged"] += 1
    COUNTS["staged_bytes"] += n * t.numel() * t.element_size()
    me = mesh.index(axes)
    return [t if i == me else dst[i].to(t.device) for i in range(n)]


def _arena():
    """(arena, slot bytes), page-locked once a CUDA tensor uses it."""
    arena, slot, locked = _ARENA
    if torch.cuda.is_initialized() and not locked:
        torch.cuda.cudart().cudaHostRegister(arena.data_ptr(),
                                             arena.numel(), 0)
        _ARENA[2] = True
    return arena, slot


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as flat uint8."""
    return t.reshape(-1).view(torch.uint8)


def _arena_gather(t: torch.Tensor, axes, mesh) -> list:
    """The gather through the arena, in rounds of at most a slot: each
    rank writes its bytes into its own slot, a barrier, each reads the
    group's slots, a second barrier (so no slot is rewritten before its
    readers are done)."""
    arena, slot = _arena()
    t = t.contiguous()
    src, ranks, group = _bytes(t), mesh.group_ranks(axes), mesh.group(axes)
    parts = {r: torch.empty_like(t) for r in ranks if r != mesh.rank}
    for a in range(0, src.numel(), slot):
        b = min(a + slot, src.numel())
        arena[mesh.rank * slot:mesh.rank * slot + b - a].copy_(src[a:b])
        dist.barrier(group=group)
        for r, p in parts.items():
            _bytes(p)[a:b].copy_(arena[r * slot:r * slot + b - a])
        dist.barrier(group=group)
    if t.is_cuda:
        COUNTS["staged"] += 1
        COUNTS["staged_bytes"] += len(ranks) * src.numel()
    return [t if r == mesh.rank else parts[r] for r in ranks]


def _sum_parts(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``t`` over ``axes``, added in rank order."""
    COUNTS["all_reduce"] += 1
    parts = _gather_parts(t, axes, mesh, "all_reduce")
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def _exchange(send: torch.Tensor, axes, mesh,
              kind: str = "all_to_all") -> torch.Tensor:
    """All-to-all over ``axes``: ``send`` is (n, ...) with row i bound for
    the group's i-th rank; returns (n, ...) whose row i came from the
    group's i-th rank.  Through the arena (in rounds of at most a slot)
    each rank writes its ``send`` and reads only its own row of every
    slot; else gloo's all-to-all (a CUDA tensor staged through pinned
    buffers).  Counted in ``WIRE`` as ``kind``."""
    send = send.contiguous()
    _wire(kind, send.numel() * send.element_size(), axes, mesh)
    with _transport():
        return _exchange_moved(send, axes, mesh)


def _exchange_moved(send: torch.Tensor, axes, mesh) -> torch.Tensor:
    n, me, group = mesh.size(axes), mesh.index(axes), mesh.group(axes)
    if mesh.backend == "fake":
        return send
    if mesh.backend == "gloo" and _ARENA:
        arena, slot = _arena()
        ranks = mesh.group_ranks(axes)
        rows = send.view(n, -1).view(torch.uint8)          # (n, row bytes)
        recv = torch.empty_like(send)
        out = recv.view(n, -1).view(torch.uint8)
        out[ranks.index(mesh.rank)] = rows[me]
        w = max(slot // n, 1)
        for a in range(0, rows.shape[1], w):
            b = min(a + w, rows.shape[1])
            arena[mesh.rank * slot:mesh.rank * slot + n * (b - a)].view(
                n, b - a).copy_(rows[:, a:b])
            dist.barrier(group=group)
            for i, r in enumerate(ranks):
                if r != mesh.rank:
                    out[i, a:b].copy_(arena[r * slot:r * slot + n * (b - a)]
                                      .view(n, b - a)[me])
            dist.barrier(group=group)
        if send.is_cuda:
            COUNTS["staged"] += 1
            COUNTS["staged_bytes"] += rows.numel() + (n - 1) * rows.shape[1]
        return recv
    if not (send.is_cuda and mesh.backend == "gloo"):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv
    src = _pinned(send.dtype, send.numel(), "in").view(send.shape)
    src.copy_(send)
    dst = _pinned(send.dtype, send.numel(), "out").view(send.shape)
    dist.all_to_all_single(dst, src, group=group)
    COUNTS["staged"] += 1
    COUNTS["staged_bytes"] += 2 * send.numel() * send.element_size()
    return dst.to(send.device)


class _AllGather(torch.autograd.Function):
    """Forward: the parts concatenated.  Backward: this rank's slice of
    the gradient, unsummed: every rank of the group computes the same
    loss from the gathered tensor, so its gradient is already whole."""

    @staticmethod
    def forward(ctx, t, axes, dim, mesh):
        ctx.axes, ctx.dim, ctx.mesh, ctx.n = axes, dim, mesh, t.shape[dim]
        return torch.cat(_gather_parts(t, axes, mesh), dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the identity (a
    row-parallel output: each rank's partial sum takes the whole
    gradient of the replicated result)."""

    @staticmethod
    def forward(ctx, t, axes, mesh):
        return _sum_parts(t, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity.  Backward: the sum over "model" (the
    replicated input of a column-parallel projection: each rank's columns
    give a partial gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_parts(g.contiguous(), "model", ctx.mesh), None


class _ModelColumns(torch.autograd.Function):
    """Forward: this rank's entries of a replicated leaf viewed as
    (groups, |model|, n / groups): block ``[:, rank]`` (a qkv bias cut to
    the rank's columns with one group; a gate-major bias cut to the
    rank's heads of each gate with one group a gate).  Backward: the
    ranks' slices of the gradient gathered over "model" and put back in
    place, so the leaf's gradient is whole and the same on every model
    rank, as a replicated leaf's is."""

    @staticmethod
    def forward(ctx, b, n, groups, mesh):
        ctx.mesh, ctx.groups = mesh, groups
        md = mesh.size("model")
        return b.view(groups, md, n // groups)[:, mesh.index("model")] \
            .reshape(n).clone()

    @staticmethod
    def backward(ctx, g):
        COUNTS["all_gather"] += 1
        parts = _gather_parts(g.contiguous(), "model", ctx.mesh)
        whole = torch.stack([p.view(ctx.groups, -1) for p in parts], 1)
        return whole.reshape(-1), None, None, None


class _GatherForSplit(torch.autograd.Function):
    """Forward: the parts concatenated, as ``all_gather``'s.  Backward:
    the gradient summed over the group and this rank's block kept (a
    reduce-scatter): each rank's consumer reads another slice of the
    gathered tensor, so each rank's gradient is a partial one."""

    @staticmethod
    def forward(ctx, t, axes, dim, mesh):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, mesh
        return torch.cat(_gather_parts(t, axes, mesh), dim)

    @staticmethod
    def backward(ctx, g):
        COUNTS["reduce_scatter"] += 1
        n = ctx.mesh.size(ctx.axes)
        send = torch.stack(g.chunk(n, ctx.dim))
        recv = _exchange(send, ctx.axes, ctx.mesh, "reduce_scatter")
        out = recv[0].clone()
        for r in recv[1:]:
            out += r
        return out, None, None, None


def all_gather(t: torch.Tensor, axes, dim: int = 0, mesh=None):
    """The shards of ``t`` along ``axes``, concatenated on ``dim`` in
    rank order (``jax.lax.all_gather(..., tiled=True)``).  For a consumer
    replicated over ``axes`` (the logits): the backward takes this rank's
    slice of the gradient."""
    mesh = _mesh(mesh)
    if mesh.size(axes) == 1:
        return t
    COUNTS["all_gather"] += 1
    return _AllGather.apply(t, axes, dim, mesh)


def all_reduce_sum(t: torch.Tensor, axes, mesh=None):
    """The sum of ``t`` over ``axes`` (``jax.lax.psum``), added in rank
    order: bitwise equal on every rank of the group, dtype kept.  The
    backward is the identity."""
    mesh = _mesh(mesh)
    if mesh.size(axes) == 1:
        return t
    return _AllReduceSum.apply(t, axes, mesh)


def all_reduce_sum_many(tensors, axes, mesh=None) -> list:
    """``all_reduce_sum`` of each tensor, in one collective per dtype
    (not differentiable: for gradients after the backward)."""
    mesh = _mesh(mesh)
    tensors = list(tensors)
    if mesh.size(axes) == 1:
        return tensors
    out = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = _sum_parts(torch.cat([tensors[i].reshape(-1) for i in idx]),
                          axes, mesh)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def copy_to_model(x: torch.Tensor, mesh=None):
    """``x`` as the replicated input of a column-parallel projection: the
    identity, whose backward sums the gradient over "model"."""
    mesh = _mesh(mesh)
    if mesh.size("model") == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def model_columns(b: torch.Tensor, n: int, mesh=None, groups: int = 1):
    """This rank's ``n`` entries of the replicated vector ``b`` along
    "model": its column block, or with ``groups`` > 1 its block of each
    of ``groups`` equal runs of ``b`` (a gate-major bias, [i heads | f
    heads], cut to the rank's heads of each gate); the backward gathers
    the gradient whole."""
    mesh = _mesh(mesh)
    if b.shape[0] == n:
        return b
    return _ModelColumns.apply(b, n, groups, mesh)


def gather_for_split(t: torch.Tensor, dim: int = -1, mesh=None,
                     axes="model"):
    """A column-parallel output gathered whole over "model" on ``dim``
    for consumers that each take another slice of it (a rank's heads of
    a projection whose stored columns are not laid out by heads, or B and
    C that every head reads): the forward is ``all_gather``'s, the
    backward a reduce-scatter over "model" (``all_gather``'s slice of
    the gradient would drop the other ranks' parts).  ``axes``: the data
    axes for a sequence split over them (``sharding/sequence.py``: each
    rank's queries read another part of the gathered keys)."""
    mesh = _mesh(mesh)
    if mesh.size(axes) == 1:
        return t
    COUNTS["gather_for_split"] += 1
    return _GatherForSplit.apply(t.contiguous(), axes, dim % t.ndim, mesh)


def all_to_all(t: torch.Tensor, split_dim: int, cat_dim: int, axes="model",
               mesh=None) -> torch.Tensor:
    """Block i of ``t`` along ``split_dim`` (|axes| equal blocks) goes to
    the group's i-th rank; the blocks this rank receives are concatenated
    along ``cat_dim`` in rank order (``jax.lax.all_to_all(...,
    tiled=True)``).  One ``_exchange``, counted as ``all_to_all``.  Not
    differentiable: the serve paths' exchanges (``layers``' kv-split
    attention over a cache)."""
    mesh = _mesh(mesh)
    n = mesh.size(axes)
    if n == 1:
        return t
    assert not (torch.is_grad_enabled() and t.requires_grad), \
        "all_to_all has no backward"
    COUNTS["all_to_all"] += 1
    recv = _exchange(torch.stack(t.chunk(n, split_dim)), axes, mesh)
    return torch.cat(recv.unbind(0), cat_dim % t.ndim)


def reduce_scatter(t: torch.Tensor, dim: int, axes="model",
                   mesh=None) -> torch.Tensor:
    """The sum of ``t`` over ``axes``, this rank's block along ``dim``
    (``jax.lax.psum_scatter(..., tiled=True)``): one ``_exchange``, the
    received blocks added in rank order, so each block's sum has the
    same bits whichever rank holds it.  Not differentiable (the serve
    paths' partial attention scores)."""
    mesh = _mesh(mesh)
    n = mesh.size(axes)
    if n == 1:
        return t
    assert not (torch.is_grad_enabled() and t.requires_grad), \
        "reduce_scatter has no backward"
    COUNTS["reduce_scatter"] += 1
    recv = _exchange(torch.stack(t.chunk(n, dim)), axes, mesh,
                     "reduce_scatter")
    out = recv[0].clone()
    for r in recv[1:]:
        out += r
    return out


def _dp_dims(spec, dp) -> list:
    """The dims a spec shards over the data axes ``dp``."""
    want = dp[0] if len(dp) == 1 else tuple(dp)
    return [i for i, s in enumerate(spec or ()) if s == want]


class _Unshard(torch.autograd.Function):
    """Forward: the tensors' data-sharded dims gathered, in one
    collective.  Backward: the reduce-scatter, in one collective: each
    gathered gradient summed over the data ranks (each rank's loss is
    over rows of its own) and this rank's block kept."""

    @staticmethod
    def forward(ctx, mesh, dp, dims, *tensors):
        ctx.mesh, ctx.dp, ctx.dims = mesh, dp, dims
        ctx.shapes = [t.shape for t in tensors]
        ctx.like = tensors[0].new_empty(())
        flat = torch.cat([t.reshape(-1) for t in tensors])
        parts = _gather_parts(flat, dp, mesh)
        out, off = [], 0
        for t, dim in zip(tensors, dims):
            n = t.numel()
            out.append(torch.cat([p[off:off + n].view(t.shape)
                                  for p in parts], dim))
            off += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, dp, g = ctx.mesh, ctx.dp, ctx.mesh.size(ctx.dp)
        COUNTS["reduce_scatter"] += 1
        # row r: every tensor's block bound for data rank r, flattened
        send = torch.cat([
            (ctx.like.new_zeros((g, *s)) if gr is None else
             torch.stack(gr.chunk(g, dim)))
            .reshape(g, -1) for gr, s, dim in zip(grads, ctx.shapes,
                                                  ctx.dims)], 1)
        recv = _exchange(send, dp, mesh, "reduce_scatter")
        out = recv[0].clone()
        for r in recv[1:]:
            out += r
        res, off = [], 0
        for s in ctx.shapes:
            n = math.prod(s)
            res.append(out[off:off + n].view(s))
            off += n
        return (None, None, None, *res)


def unshard(*tensors, mesh=None) -> tuple:
    """FSDP unshard-on-use: each tensor's dims that its ``_pspec`` (its
    spec, kept by ``shard_params``) shards over the data axes are
    gathered back, in ONE collective for all of them; model-sharded dims
    stay local.  The backward reduce-scatters their gradients, again in
    one collective."""
    mesh = _mesh(mesh)
    dp = dp_axes(mesh)
    todo = [i for i, t in enumerate(tensors)
            if _dp_dims(getattr(t, "_pspec", None), dp)]
    if not todo or mesh.size(dp) == 1:
        return tensors
    dtype = tensors[todo[0]].dtype
    assert all(tensors[i].dtype == dtype for i in todo), \
        "unshard gathers tensors of one dtype at a time"
    COUNTS["all_gather"] += 1
    dims = tuple(_dp_dims(tensors[i]._pspec, dp)[0] for i in todo)
    full = _Unshard.apply(mesh, dp, dims, *(tensors[i] for i in todo))
    out = list(tensors)
    for i, f in zip(todo, full):
        out[i] = f
    return tuple(out)


def shard_tensor(mesh, t: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a contiguous copy, never
    a view: a block along the leading dim would otherwise keep the whole
    storage alive): each dim named by the spec split evenly over its
    axes, at the rank's position along them."""
    idx = []
    for dim, s in enumerate(spec):
        if s is None:
            idx.append(slice(None))
            continue
        n = mesh.size(s)
        assert t.shape[dim] % n == 0, (t.shape, spec)
        w = t.shape[dim] // n
        i = mesh.index(s)
        idx.append(slice(i * w, (i + 1) * w))
    return t[tuple(idx)].clone(memory_format=torch.contiguous_format)


def shard_params(mesh, params, device=None) -> dict:
    """Each parameter of ``params`` (an ``nn.Module``) replaced, in place,
    by this rank's block under ``sharding/rules.param_pspecs``, on
    ``device`` (default: where it lies), with its spec kept as ``_pspec``
    for ``unshard`` and the train step; the whole copy is freed.  A
    parameter that is a shard already (``model.init_model(mesh=)``) is
    kept.  Returns {name: spec}."""
    specs, _ = param_pspecs(mesh, params)
    for name, p in params.named_parameters():
        if getattr(p, "_pspec", None) is None:  # not a shard already
            p.data = shard_tensor(mesh, p.data, specs[name])
            p._pspec = specs[name]
        p.data = p.data.to(device or p.device)
    return specs


def spec_axes(mesh, spec) -> tuple:
    """The mesh axes ``spec`` shards over, in mesh order."""
    named = {a for s in spec or () if s is not None
             for a in ((s,) if isinstance(s, str) else s)}
    return tuple(a for a in mesh.axis_names if a in named)


def gather_whole(t: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """``t`` whole from the shards under ``spec`` (each sharded dim
    gathered over its axes; not differentiable)."""
    mesh = _mesh(mesh)
    for dim, s in enumerate(spec or ()):
        if s is not None and mesh.size(s) > 1:
            COUNTS["all_gather"] += 1
            t = torch.cat(_gather_parts(t.contiguous(), s, mesh), dim)
    return t


def world_max(x: float) -> float:
    """The largest of every rank's ``x`` (a host value, the same on every
    rank)."""
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def barrier():
    """Every rank of the world meets here."""
    dist.barrier()


def local_rows(mesh, dp, n: int) -> slice:
    """This rank's rows of an ``n``-row batch sharded over ``dp``; every
    row where ``n`` does not divide over them (a served batch below the
    data axes is whole on every data rank, ``activations.whole_rows``)."""
    g = mesh.size(dp)
    if n % g:
        return slice(0, n)
    w = n // g
    i = mesh.index(dp)
    return slice(i * w, (i + 1) * w)


def model_index(mesh) -> int:
    """This rank's position along "model"."""
    return mesh.index("model")
