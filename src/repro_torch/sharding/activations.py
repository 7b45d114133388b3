"""The mesh context, injected without threading a mesh through the model
code (counterpart of ``repro/sharding/activations.py``).

``activation_sharding(spec, mesh)`` holds the PartitionSpec of the
residual stream and the mesh of the running SPMD program;
``manual_dp_context()`` reads them back, as the model's serve path does
to take its sharded branches.  ``runtime/steps.serve_mesh_context`` sets
both around a mesh server's steps:

    with serve_mesh_context(mesh):
        logits, cache = decode_step(params, cache, tokens, mask)

In the reference the spec constrains the partitioner's placement of the
residual stream.  Here every rank runs its own program on its own rows
(one process per rank, torch.distributed), so there is no partitioner to
steer: ``constrain``, ``constrain_logits`` and ``constrain_tokens`` are
identities, kept so that code written against the reference's API runs.

A served batch that does not divide over the data axes (the reference's
``batch_pspec`` replicates such rows) runs inside ``whole_rows``: every
data rank holds every row and computes what one device computes, the
weights still FSDP over "data" and tensor-parallel over "model".
``row_axes`` then names no axis, so nothing that counts rows (a plan's
stats, the MoE's routing and drops, the logits' gather) adds the data
ranks' copies together, and ``context_parallel`` gives the data axes a
dense or ring KV cache is split over by sequence (``layers.py``).

A training microbatch that does not divide over the data axes runs
inside ``sequence_split`` (``mesh_context(mesh, microbatch=)`` enters it):
every data rank holds every row of the microbatch and its own equal
slice of the S positions (``data/pipeline.local_batch``), so each data
rank computes DIFFERENT tokens of the same rows.  ``row_axes`` still
names the data axes (every token mean is a mean over them), and
``sequence_shard`` gives a rank's first position: attention gathers k and
v over the data axes along S, the MoE routes the global token groups,
and a recurrence hands its state from each shard to the next
(``sharding/sequence.py``).
"""
from __future__ import annotations

import collections
import contextlib
from contextvars import ContextVar

_SPEC: ContextVar = ContextVar("activation_spec", default=None)
_MESH: ContextVar = ContextVar("activation_mesh", default=None)
_WHOLE: ContextVar = ContextVar("whole_rows", default=False)
_SEQ: ContextVar = ContextVar("sequence_split", default=False)


@contextlib.contextmanager
def activation_sharding(spec, mesh=None):
    """Hold ``spec`` (the residual stream's PartitionSpec) and ``mesh``
    (the mesh the program runs on, ``launch/mesh.HostMesh``) for the
    duration."""
    tok, mtok = _SPEC.set(spec), _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(mtok)
        _SPEC.reset(tok)


@contextlib.contextmanager
def mesh_context(mesh, microbatch: int = 0):
    """The context of one rank's part of an SPMD program on ``mesh``: the
    mesh and the residual stream batch-sharded over its data axes,
    ``P(dp, None, None)``.  ``microbatch`` (training): the global
    microbatch's rows; where they do not divide over the data axes the
    block runs under ``sequence_split``.  ``mesh=None`` is a no-op, so
    single-device callers share the code path
    (``runtime/steps.serve_mesh_context`` and ``train_mesh_context``)."""
    if mesh is None:
        yield None
        return
    from repro_torch.sharding.rules import P, dp_axes
    dp = dp_axes(mesh)
    below = microbatch % mesh.size(dp) != 0
    with activation_sharding(P(dp, None, None), mesh), \
            sequence_split() if below else contextlib.nullcontext():
        yield mesh


def with_current_context(fn):
    """``fn`` bound to the enclosing context's spec and mesh, which it
    sees wherever it runs later: the backward's recompute of a
    checkpointed block runs on autograd's device thread, which context
    variables do not reach."""
    spec, mesh, whole, seq = _SPEC.get(), _MESH.get(), _WHOLE.get(), \
        _SEQ.get()

    def bound(*args):
        with activation_sharding(spec, mesh), whole_rows(whole), \
                sequence_split(seq):
            return fn(*args)
    return bound


def current_mesh():
    """The mesh of the enclosing context, or None."""
    return _MESH.get()


def constrain(x):
    """Identity: an SPMD rank holds its own rows already."""
    return x


def constrain_logits(x):
    """Identity (the reference constrains (B, S, V) logits to batch over
    data and vocab over model)."""
    return x


def constrain_tokens(x):
    """Identity (the reference constrains (B, S) per-token values to
    batch over data)."""
    return x


def manual_dp_context():
    """(mesh, dp_axes) inside a mesh context with a batch-sharded
    activation spec; (None, ()) outside one."""
    spec, mesh = _SPEC.get(), _MESH.get()
    if spec is None or spec[0] is None or mesh is None:
        return None, ()
    dp = spec[0]
    return mesh, tuple(dp) if isinstance(dp, (tuple, list)) else (dp,)


@contextlib.contextmanager
def whole_rows(on: bool = True):
    """Within the block (``on``) every data rank holds the whole batch:
    a served batch below the data axes, replicated over them as the
    reference's ``batch_pspec`` places it."""
    tok = _WHOLE.set(bool(on))
    try:
        yield
    finally:
        _WHOLE.reset(tok)


def row_axes() -> tuple:
    """The axes the rows in flight are split over: the data axes inside a
    batch-sharded mesh context, none outside one or under
    ``whole_rows`` (every data rank holds every row)."""
    mesh, dp = manual_dp_context()
    return () if mesh is None or _WHOLE.get() else dp


def context_parallel():
    """(mesh, data axes) where the rows are whole on every data rank of a
    mesh with more than one (``whole_rows``): a dense or ring KV cache is
    then split over the data axes by sequence (``rules.cache_pspecs``),
    each rank attending over its slice.  None elsewhere."""
    mesh, dp = manual_dp_context()
    if mesh is None or not _WHOLE.get() or mesh.size(dp) == 1:
        return None
    return mesh, dp


@contextlib.contextmanager
def sequence_split(on: bool = True):
    """Within the block (``on``) a training microbatch below the data
    axes: every data rank holds every row and its own slice of the
    positions, the data ranks' slices in rank order (``sequence_shard``)."""
    tok = _SEQ.set(bool(on))
    try:
        yield
    finally:
        _SEQ.reset(tok)


class SeqShard(collections.namedtuple("SeqShard", "mesh dp start total")):
    """A data rank's slice of a sequence split over the data axes (a
    training row under ``sequence_split``, a context-parallel KV cache):
    the mesh, the data axes, its first position and the whole length."""


def sequence_shard(n: int):
    """The ``SeqShard`` of a rank holding ``n`` positions of each row
    inside ``sequence_split`` on a mesh with more than one data rank:
    positions [i n, (i + 1) n) of g n, i its index along the data axes.
    None elsewhere."""
    mesh, dp = manual_dp_context()
    if mesh is None or not _SEQ.get() or mesh.size(dp) == 1:
        return None
    return SeqShard(mesh, dp, mesh.index(dp) * n, n * mesh.size(dp))
