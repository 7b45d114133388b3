"""Collectives over named mesh axes: the port's ``jax.lax.psum`` and
``all_gather`` (no reference counterpart: in the reference they are
primitives of ``shard_map``).

Every collective of the mesh serving path goes through here, so the
backend is one choice (``launch/mesh.HostMesh``): gloo, or NCCL where
each rank has a card of its own.  Gloo runs on host memory.  Ranks of one
host that share an exchange arena (``use_host_arena``, given by
``launch/mesh.spawn_world``) move a gather's payload through it instead
of gloo's loopback TCP: each rank writes its part into its own slot, a
gloo barrier, each reads its group's slots, a second barrier (so no slot
is rewritten before its readers are done).  Otherwise a CUDA tensor under
gloo is staged through a pinned host buffer and back.  Either way a CUDA
tensor's trip through the host is copies the host waits for, counted in
``COUNTS["staged"]`` (and its bytes), and no rank's compute moves off its
device.

``all_reduce_sum`` gathers the shards and adds them in rank order, so
every rank of the group holds the same bits whatever the backend's
reduction order, and the sum of int32 stats stays int32.  ``mesh=None``
takes the mesh of the enclosing ``sharding/activations`` context.  Over
an axis of size 1 nothing is sent.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.activations import current_mesh
from repro_torch.sharding.rules import dp_axes

# launches of the collectives, and the host stagings and their bytes
COUNTS = {"all_gather": 0, "all_reduce": 0, "staged": 0, "staged_bytes": 0}
_PINNED: dict = {}
# [shared uint8 arena, bytes a rank's slot, page-locked here yet]
_ARENA: list = []


def use_host_arena(arena: torch.Tensor, slot_bytes: int):
    """Move gathers through ``arena``, a uint8 CPU tensor in memory shared
    by every rank of the world: rank r's slot is bytes [r * slot_bytes,
    (r + 1) * slot_bytes).  At its first CUDA gather a process page-locks
    the arena, so copies to and from the card run at the pinned rate."""
    _ARENA[:] = [arena, slot_bytes, False]


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


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


def _gather_parts(t: torch.Tensor, axes, mesh) -> list:
    """Every rank's ``t`` along ``axes``, in rank order, on ``t``'s
    device.  A CUDA tensor under gloo goes out through one pinned buffer
    and the other ranks' parts come back through another (copies the
    host waits for); this rank's own part is ``t`` itself."""
    n, group = mesh.size(axes), mesh.group(axes)
    nbytes = t.numel() * t.element_size()
    if mesh.backend == "gloo" and _ARENA and nbytes <= _ARENA[1]:
        return _arena_gather(t, axes, mesh, nbytes)
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


def _arena_gather(t: torch.Tensor, axes, mesh, nbytes: int) -> list:
    arena, slot, locked = _ARENA
    if t.is_cuda and not locked:
        torch.cuda.cudart().cudaHostRegister(arena.data_ptr(),
                                             arena.numel(), 0)
        _ARENA[2] = True

    def part(r):
        return arena[r * slot:r * slot + nbytes].view(t.dtype).view(t.shape)
    part(mesh.rank).copy_(t)
    group = mesh.group(axes)
    dist.barrier(group=group)
    parts = [t if r == mesh.rank else torch.empty_like(t).copy_(part(r))
             for r in mesh.group_ranks(axes)]
    dist.barrier(group=group)
    if t.is_cuda:
        COUNTS["staged"] += 1
        COUNTS["staged_bytes"] += mesh.size(axes) * nbytes
    return parts


def all_gather(t: torch.Tensor, axes, dim: int = 0, mesh=None):
    """The shards of ``t`` along ``axes``, concatenated on ``dim`` in
    rank order (``jax.lax.all_gather(..., tiled=True)``)."""
    mesh = _mesh(mesh)
    if mesh.size(axes) == 1:
        return t
    COUNTS["all_gather"] += 1
    return torch.cat(_gather_parts(t, axes, mesh), dim)


def all_reduce_sum(t: torch.Tensor, axes, mesh=None):
    """The sum of ``t`` over ``axes`` (``jax.lax.psum``), added in rank
    order: bitwise equal on every rank of the group, dtype kept."""
    mesh = _mesh(mesh)
    if mesh.size(axes) == 1:
        return t
    COUNTS["all_reduce"] += 1
    parts = _gather_parts(t, axes, mesh)
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def _dp_dims(spec, dp) -> list:
    """The dims a spec shards over the data axes ``dp``."""
    want = dp[0] if len(dp) == 1 else tuple(dp)
    return [i for i, s in enumerate(spec or ()) if s == want]


def unshard(*tensors, mesh=None) -> tuple:
    """FSDP unshard-on-use: each tensor's dims that its ``_pspec`` (its
    spec, kept by the server's ``_shard_params``) shards over the data
    axes are gathered back, in ONE collective for all of them;
    model-sharded dims stay local."""
    mesh = _mesh(mesh)
    dp = dp_axes(mesh)
    todo = [i for i, t in enumerate(tensors)
            if _dp_dims(getattr(t, "_pspec", None), dp)]
    if not todo or mesh.size(dp) == 1:
        return tensors
    dtype = tensors[todo[0]].dtype
    assert all(tensors[i].dtype == dtype for i in todo), \
        "unshard gathers tensors of one dtype at a time"
    flat = torch.cat([tensors[i].reshape(-1) for i in todo])
    COUNTS["all_gather"] += 1
    parts = _gather_parts(flat, dp, mesh)
    out, off = list(tensors), 0
    for i in todo:
        t = tensors[i]
        n = t.numel()
        (dim,) = _dp_dims(t._pspec, dp)
        out[i] = torch.cat([p[off:off + n].view(t.shape) for p in parts], dim)
        off += n
    return tuple(out)


def shard_tensor(mesh, t: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a contiguous copy): each
    dim named by the spec split evenly over its axes, at the rank's
    position along them."""
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
    return t[tuple(idx)].contiguous()


def local_rows(mesh, dp, n: int) -> slice:
    """This rank's rows of an ``n``-row batch sharded over ``dp``."""
    g = mesh.size(dp)
    assert n % g == 0, (n, g)
    w = n // g
    i = mesh.index(dp)
    return slice(i * w, (i + 1) * w)


def model_index(mesh) -> int:
    """This rank's position along "model"."""
    return mesh.index("model")
