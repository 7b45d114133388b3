"""A training microbatch below the data axes, split by sequence over them
(``activations.sequence_split``; no reference counterpart: the
reference's ``batch_pspec`` falls back to ``P(None, dp)`` and the
compiler places the rest).

Every data rank holds every row of the microbatch and an equal slice of
its S positions, data rank i positions [i S / g, (i + 1) S / g).  Two
things cross the slices:

* attention's keys and values: each rank's queries attend over the keys
  of its own and every earlier slice, so k and v are gathered whole
  along S over the data axes (``gather_sequence``).  Each rank's queries
  read another part of the gathered keys, so the gather's backward sums
  the gradient over the data ranks and keeps the rank's slice, a
  reduce-scatter (``collectives.gather_for_split`` over the data axes):
  ``all_gather``'s unsummed slice would lose the later slices' queries'
  share of a rank's k/v gradient.
* a recurrence's state (Mamba2's SSD, the mLSTM, the sLSTM): slice i
  starts from the state slice i - 1 ends with (``in_order``).  The
  handoff is one autograd node that owns its collectives: its forward
  runs g rounds, in round r rank r runs its slice from the state it
  received and every rank gathers that round's state over the data
  axes; its backward runs the rounds in reverse, rank r recomputing its
  slice from its saved initial state and pulling through the cotangents
  of its outputs and of its final state (rank r + 1's round), every rank
  gathering the cotangent of rank r's initial state.  Every rank calls
  every round's collective, forward and backward, whichever of them
  consumes the state (a collective's backward runs only where its output
  has a consumer, so one built from autograd collectives would hang
  the ranks that do not).  The slices run one after another: g times one
  slice's time (PERF.md).
"""
from __future__ import annotations

import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding.activations import sequence_shard


def gather_sequence(t: torch.Tensor, shard, upto: int | None = None):
    """``t`` (B, S / g, ...), this rank's slice of a sequence split over
    the data axes (``shard``, an ``activations.SeqShard``), gathered
    whole along dim 1 in rank order (the backward reduce-scatters), then
    cut to its first ``upto`` positions (contiguous)."""
    whole = C.gather_for_split(t, 1, shard.mesh, axes=shard.dp)
    if upto is None or upto >= whole.shape[1]:
        return whole
    return whole[:, :upto].contiguous()


def _flat(ts) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in ts])


def _unflat(flat: torch.Tensor, like) -> tuple:
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return tuple(out)


def _rounds(send, mesh, dp) -> list:
    """One round of the handoff: every data rank's ``send`` gathered."""
    C.COUNTS["all_gather"] += 1
    return C._gather_parts(send.contiguous(), dp, mesh)


class _InOrder(torch.autograd.Function):
    """The forward and reverse handoff (module docstring).  ``core(*ins,
    *state) -> (y, state')``; ``tensors`` are the inputs then the initial
    state, which only data rank 0 starts from.  Returns y and the state
    the last slice ends with (the whole sequence's, on every rank; not
    differentiable)."""

    @staticmethod
    def forward(ctx, core, mesh, dp, n_in, *tensors):
        ins, st = tensors[:n_in], tensors[n_in:]
        g, me = mesh.size(dp), mesh.index(dp)
        y = last = None
        for r in range(g):
            if r == me:
                y, fin = core(*ins, *st)
                send = _flat(fin)
            else:
                send = _flat(st).new_zeros(_flat(st).shape)
            parts = _rounds(send, mesh, dp)
            if r == me - 1:
                st = _unflat(parts[r], st)
            if r == g - 1:
                last = _unflat(parts[r], st)
        ctx.core, ctx.mesh, ctx.dp, ctx.n_in = core, mesh, dp, n_in
        ctx.save_for_backward(*ins, *st)
        ctx.mark_non_differentiable(*last)
        return (y, *last)

    @staticmethod
    def backward(ctx, dy, *_):
        mesh, dp, n_in = ctx.mesh, ctx.dp, ctx.n_in
        saved = ctx.saved_tensors
        ins, st = saved[:n_in], saved[n_in:]
        g, me = mesh.size(dp), mesh.index(dp)
        d_fin = tuple(torch.zeros_like(t) for t in st)
        d_ins = [None] * n_in
        d_st = None
        for r in reversed(range(g)):
            if r == me:
                with torch.enable_grad():
                    xs = [t.detach().requires_grad_(t.is_floating_point()
                                                    and need)
                          for t, need in zip(ins, ctx.needs_input_grad[4:])]
                    s0 = [t.detach().requires_grad_() for t in st]
                    y, fin = ctx.core(*xs, *s0)
                    want = [t for t in (*xs, *s0) if t.requires_grad]
                    grads = iter(torch.autograd.grad(
                        (y, *fin), want, (dy, *d_fin), allow_unused=True))
                got = [next(grads) if t.requires_grad else None
                       for t in (*xs, *s0)]
                d_ins = got[:n_in]
                d_st = tuple(torch.zeros_like(t) if gr is None else gr
                             for t, gr in zip(st, got[n_in:]))
                send = _flat(d_st)
            else:
                send = _flat(st).new_zeros(_flat(st).shape)
            parts = _rounds(send, mesh, dp)
            if r == me + 1:
                d_fin = _unflat(parts[r], st)
        # only data rank 0 started from the caller's state
        d_state = d_st if me == 0 else (None,) * len(st)
        return (None, None, None, None, *d_ins, *d_state)


def in_order(core, inputs, state, n: int):
    """``core(*inputs, *state) -> (y, state')`` over a rank's ``n``
    positions: as it is outside a sequence split; inside one, the
    handoff (module docstring): rank i's slice from the state rank i - 1
    ends with (data rank 0 from ``state``), returning its y and the whole
    sequence's final state."""
    shard = sequence_shard(n)
    if shard is None:
        return core(*inputs, *state)
    out = _InOrder.apply(core, shard.mesh, shard.dp, len(inputs), *inputs,
                         *state)
    return out[0], out[1:]
