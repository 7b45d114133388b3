"""Meshes of ranks (counterpart of ``repro/launch/mesh.py``), and the
launcher that starts one process per rank.

A ``HostMesh`` lays the ranks of an initialized ``torch.distributed``
process group out on named axes, ("data", "model") or ("pod", "data",
"model"), row-major as ``jax.make_mesh`` lays out devices, or
("pod",) alone (the int8 all-reduce of ``optim/compression.py``): one
world may hold several meshes over its ranks, each with groups of its
own.  It carries
what the sharding rules read (``axis_names``, and ``devices``: the array
of ranks) and a process group per axis, for ``sharding/collectives.py``.
It is built on ``torch.distributed.device_mesh.init_device_mesh``.

Backends: gloo on the CPU, and gloo too when several ranks share one
card (NCCL refuses two ranks on one device); NCCL where each rank has a
card of its own.  ``spawn_world`` starts the ranks of one host and gives
them a shared-memory exchange arena, through which the gloo collectives
move their payloads instead of gloo's loopback TCP
(``sharding/collectives.py``).
"""
from __future__ import annotations

import math
import socket
from multiprocessing import forkserver, resource_tracker

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_MESH_AXES = ("pod", "data", "model")


class MeshShape:
    """A mesh's axis names and array of ranks without a process group:
    what the refusals (``models.model.check_mesh_trainable``) read before
    the ranks exist."""

    def __init__(self, shape, axis_names=("data", "model")):
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(math.prod(shape)).reshape(shape)


class HostMesh:
    """The ranks of the running world on named axes."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        assert dist.is_initialized(), \
            "a mesh needs an initialized process group (spawn_world)"
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"ranks; the world has {world}")
        from torch.distributed.device_mesh import init_device_mesh
        self.axis_names = axis_names
        self.devices = np.arange(world).reshape(shape)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self.device_mesh = init_device_mesh(
            "cuda" if self.backend == "nccl" else "cpu", shape,
            mesh_dim_names=axis_names)
        self._groups = {(a,): self.device_mesh.get_group(a)
                        for a in axis_names}
        from repro_torch.sharding.rules import dp_axes
        dp = dp_axes(self)
        if len(dp) > 1 and set(dp) <= set(axis_names):
            self._groups[dp] = self._flat_group(dp)

    def _flat_group(self, axes):
        """A process group over several axes: every rank calls
        ``new_group`` for every group, in one order."""
        dims = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in dims]
        rows = np.transpose(self.devices, rest + dims).reshape(
            -1, math.prod(self.devices.shape[i] for i in dims))
        mine = None
        for row in rows:
            g = dist.new_group(ranks=[int(r) for r in row])
            if self.rank in row:
                mine = g
        return mine

    @staticmethod
    def _axes(axes) -> tuple:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple)."""
        sizes = dict(zip(self.axis_names, self.devices.shape))
        return math.prod(sizes[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's position along ``axes``, row-major over them."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.size(a) + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that share this rank's
        coordinates off ``axes``."""
        return self._groups[self._axes(axes)]

    def group_ranks(self, axes) -> list[int]:
        """The global ranks of ``group(axes)``, in its rank order (the
        axes in mesh order)."""
        axes = self._axes(axes)
        assert list(axes) == sorted(axes, key=self.axis_names.index), axes
        idx = tuple(slice(None) if a in axes else self.coords[a]
                    for a in self.axis_names)
        return [int(r) for r in self.devices[idx].reshape(-1)]


def make_host_mesh(*, data: int | None = None, model: int = 1) -> HostMesh:
    """A ("data", "model") mesh over the running world (``data``
    defaults to world // model)."""
    world = dist.get_world_size()
    data = data or world // model
    return HostMesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """The reference's production layouts: (16, 16) ("data", "model"),
    or (2, 16, 16) ("pod", "data", "model") multi-pod.  A world of
    another size raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = _MESH_AXES if multi_pod else _MESH_AXES[1:]
    return HostMesh(shape, axes)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, backend, init_method, arena, args):
    from repro_torch.sharding import collectives
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    if arena is not None:
        collectives.use_host_arena(arena, arena.numel() // world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world: int, args=(), *, backend: str = "gloo",
                init_method: str | None = None, exchange_mib: int = 64):
    """Run ``fn(rank, *args)`` in ``world`` fresh processes that form one
    process group (``init_method`` default: a free localhost port), and
    wait for all of them; a rank's exception is raised here.  Under gloo
    the ranks share an exchange arena of ``exchange_mib`` MiB a rank,
    allocated here (0: none; a larger gather goes through gloo)."""
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    arena = None
    if backend == "gloo" and exchange_mib:
        arena = torch.empty(world * exchange_mib * 2**20,
                            dtype=torch.uint8).share_memory_()
    # children fork from a server process that imported torch and the
    # port once, instead of each importing them afresh
    mp.set_forkserver_preload(["torch", "repro_torch.runtime.server",
                               "repro_torch.launch.mesh"])
    try:
        mp.start_processes(_rank_main,
                           args=(fn, world, backend, init_method, arena,
                                 args),
                           nprocs=world, join=True,
                           start_method="forkserver")
    finally:
        # the fork server and the resource tracker it started outlive the
        # ranks (and, by a moment, this process): stop both here, so that
        # no process of the world is left once this returns
        forkserver._forkserver._stop()
        resource_tracker._resource_tracker._stop()
