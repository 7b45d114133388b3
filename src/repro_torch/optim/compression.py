"""int8 error-feedback gradient compression for the cross-pod axis
(counterpart of ``repro/optim/compression.py``).

The multi-pod mesh's "pod" axis carries only the data-parallel gradient
all-reduce, over the slowest links.  A float32 all-reduce moves about
2 x 4 bytes a parameter; an int8 all-gather and a local mean move 1 byte
a parameter and rank (and one float32 scale a leaf).

Scheme (error feedback, as in 1-bit SGD / EF-SGD):
    e     <- residual carried from the last step (f32, gradient-shaped)
    g'    = g + e
    q     = round(g' / scale) clipped to int8, scale = max|g'| / 127
    e'    = g' - q * scale                      (the new residual)
    g_out = the mean over the pods of the dequantized q

The arithmetic is the reference's: the scale ``max|g'| / 127 + 1e-12``,
round half to even, the clip to +-127, the int8 all-gather of q and the
float32 all-gather of the scales, and the mean.  Here every rank runs
its own process, so the function takes the rank's gradients and runs
the two all-gathers over the named axis of a ``launch/mesh.HostMesh``
(``sharding/collectives.py``), any axis of any mesh: ``("pod",)`` alone,
or the leading axis of ``make_production_mesh(multi_pod=True)``.  All
leaves of a call travel in the same two collectives.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import collectives as C


def _quantize(g: torch.Tensor):
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _rebuild(tree, values, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (k,)) for k, v in tree.items()}
    return values[prefix]


def _encode(g: torch.Tensor, e: torch.Tensor):
    """One rank's leaf: (q, scale, new residual) of ``g + e`` in float32."""
    g32 = g.to(torch.float32) + e
    q, scale = _quantize(g32)
    return q, scale, g32 - q.to(torch.float32) * scale


def _decode_mean(qs: torch.Tensor, scales: torch.Tensor, like: torch.Tensor):
    """The mean over the gathered ranks (dim 0) of ``qs * scales``, in
    ``like``'s dtype."""
    sa = scales.reshape((-1,) + (1,) * like.ndim)
    return torch.mean(qs.to(torch.float32) * sa, dim=0).to(like.dtype)


def ef_int8_allreduce_tree(grads, err, axis_name: str = "pod", mesh=None):
    """Per-leaf int8 error-feedback mean over ``axis_name``.

    ``grads`` and ``err`` are this rank's trees (nested dicts of tensors,
    the same structure); ``mesh`` defaults to the enclosing mesh context's.
    Returns (mean_grads, new_err) with the same structure: the mean in
    each gradient's dtype, the residual in float32."""
    paths, gs = zip(*_leaves(grads))
    errs = dict(_leaves(err))
    qs, scales, new_e = zip(*(_encode(g, errs[p]) for p, g in zip(paths, gs)))
    # the int8 all-gather (1 byte a parameter) and the scales' beside it
    q_all = C.all_gather(torch.cat([q.reshape(-1) for q in qs])[None],
                         axis_name, 0, mesh)
    s_all = C.all_gather(torch.stack(scales)[None], axis_name, 0, mesh)
    means, off = {}, 0
    for i, (p, g) in enumerate(zip(paths, gs)):
        n = g.numel()
        means[p] = _decode_mean(q_all[:, off:off + n].reshape(-1, *g.shape),
                                s_all[:, i], g)
        off += n
    return (_rebuild(grads, means),
            _rebuild(grads, dict(zip(paths, new_e))))


def init_error_feedback(params):
    """Zero float32 residuals shaped like ``params`` (a nested dict of
    tensors)."""
    return _rebuild(params, {p: torch.zeros(t.shape, dtype=torch.float32,
                                            device=t.device)
                             for p, t in _leaves(params)})
