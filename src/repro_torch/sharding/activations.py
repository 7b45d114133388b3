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
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

_SPEC: ContextVar = ContextVar("activation_spec", default=None)
_MESH: ContextVar = ContextVar("activation_mesh", default=None)
_WHOLE: ContextVar = ContextVar("whole_rows", default=False)


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
def mesh_context(mesh):
    """The context of one rank's part of an SPMD program on ``mesh``: the
    mesh and the residual stream batch-sharded over its data axes,
    ``P(dp, None, None)``.  ``mesh=None`` is a no-op, so single-device
    callers share the code path (``runtime/steps.serve_mesh_context`` and
    ``train_mesh_context``)."""
    if mesh is None:
        yield None
        return
    from repro_torch.sharding.rules import P, dp_axes
    with activation_sharding(P(dp_axes(mesh), None, None), mesh):
        yield mesh


def with_current_context(fn):
    """``fn`` bound to the enclosing context's spec and mesh, which it
    sees wherever it runs later: the backward's recompute of a
    checkpointed block runs on autograd's device thread, which context
    variables do not reach."""
    spec, mesh, whole = _SPEC.get(), _MESH.get(), _WHOLE.get()

    def bound(*args):
        with activation_sharding(spec, mesh), whole_rows(whole):
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
