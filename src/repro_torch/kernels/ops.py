"""Host-side wrappers around the approximator-MLP kernels
(counterpart of ``repro/kernels/ops.py``).

Responsibilities kept OUT of the kernels:
  * padding feature dims to lane multiples (128) and rows to tile multiples;
  * sorting rows by classifier class and building the per-tile class index
    (every tile must be single-class for the weight switch);
  * scattering results back to the original row order.

Zero-padding is semantics-preserving for a tanh MLP (tanh(0) = 0 contributes
nothing through zero weight columns).  Every index and count tensor is
int32, as in the reference (torch's argsort/bincount/cumsum give int64),
and nothing here waits for the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import fused_dispatch, mcma_mlp, switched_mlp

LANE = 128


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def mlp_operands(x: torch.Tensor, w1, b1, w2, b2, *, block_t: int):
    """``mlp_apply``'s kernel operands: x's rows zero-padded to a multiple
    of ``block_t`` and every feature dim to a multiple of LANE."""
    t, d_in = x.shape
    d_h, d_out = w1.shape[1], w2.shape[1]
    tp, d_in_p = _pad_to(max(t, 1), block_t), _pad_to(d_in, LANE)
    d_h_p, d_out_p = _pad_to(d_h, LANE), _pad_to(d_out, LANE)
    return (F.pad(x, (0, d_in_p - d_in, 0, tp - t)),
            F.pad(w1, (0, d_h_p - d_h, 0, d_in_p - d_in)),
            F.pad(b1, (0, d_h_p - d_h)),
            F.pad(w2, (0, d_out_p - d_out, 0, d_h_p - d_h)),
            F.pad(b2, (0, d_out_p - d_out)))


def mlp_apply(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, *,
              block_t: int = 256) -> torch.Tensor:
    """Fused approximator MLP on arbitrary (T, d_in) inputs: the padded
    operands through the kernel, the result sliced back."""
    y = mcma_mlp.mlp_forward(*mlp_operands(x, w1, b1, w2, b2,
                                           block_t=block_t), block_t=block_t)
    return y[:x.shape[0], :w2.shape[1]]


def bincount(x: torch.Tensor, length: int) -> torch.Tensor:
    """JAX's ``bincount(x, length=n)`` for non-negative ``x``: exactly
    ``length`` int32 bins, values at or past ``length`` dropped.  Built
    with a scatter-add into a fixed-size buffer, because
    ``torch.bincount`` sizes its output from the data and so waits for
    the device."""
    buf = torch.zeros(length + 1, dtype=torch.int32, device=x.device)
    idx = x.long().clamp(max=length)
    buf.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return buf[:length]


def worst_case_rows(t: int, n: int, block_t: int) -> int:
    """Static padded row count class_sort_plan produces for T rows and n
    classes — i.e. the rows the switched kernel actually launches."""
    return _pad_to(t + n * block_t, block_t)


def prepad_switched_weights(w1, b1, w2, b2, *, pseudo_classes: int = 1):
    """One-time serving form of an approximator weight stack.

    Appends ``pseudo_classes`` all-zero approximators (the nC/over-capacity
    rows ride through the switched kernel under them with exactly-zero
    contribution) and lane-pads every feature dim to a multiple of LANE.

    w1: (n, d_in, d_h); b1: (n, d_h); w2: (n, d_h, d_out); b2: (n, d_out)
    -> same order with leading dim n + pseudo_classes and padded features.
    """
    _, d_in, d_h = w1.shape
    d_out = w2.shape[2]
    d_in_p, d_h_p, d_out_p = (_pad_to(d_in, LANE), _pad_to(d_h, LANE),
                              _pad_to(d_out, LANE))
    z = pseudo_classes
    return (F.pad(w1, (0, d_h_p - d_h, 0, d_in_p - d_in, 0, z)),
            F.pad(b1, (0, d_h_p - d_h, 0, z)),
            F.pad(w2, (0, d_out_p - d_out, 0, d_h_p - d_h, 0, z)),
            F.pad(b2, (0, d_out_p - d_out, 0, z)))


def gather_resident_stacks(w1, b1, w2, b2, residency: torch.Tensor):
    """Resident view of a LIBRARY weight stack (prepadded, pseudo-class
    last): the rows of the ``residency`` library ids plus the pseudo-class
    row, ``(n_resident + 1, ...)``.

    Degenerate ids are pinned: an id outside ``[0, library_size)``
    resolves to the zero pseudo-class row (the slot serves exact zeros),
    and duplicate ids duplicate the weight row.
    """
    lib = w1.shape[0] - 1                       # library_size (pseudo last)
    r = residency.to(torch.int32)
    r = torch.where((r >= 0) & (r < lib), r, lib)
    idx = torch.cat([r, torch.full((1,), lib, dtype=torch.int32,
                                   device=r.device)]).long()
    return w1[idx], b1[idx], w2[idx], b2[idx]


def class_sort_plan(cls: torch.Tensor, n: int, block_t: int):
    """Static-shape plan grouping rows by class into single-class row-tiles.

    cls: (T,) int32 in [0, n).  Returns ``(order, pos, tile_cls,
    padded_sizes, t_pad)``: original row ``order[i]`` lands at padded
    position ``pos[i]`` of a (t_pad, ...) buffer in which every
    ``block_t``-row tile holds rows of exactly one class
    (``tile_cls[tile]``); worst-case padding is one partial tile per class,
    so ``t_pad`` is static.
    """
    t = cls.shape[0]
    t_pad = worst_case_rows(t, n, block_t)
    assert t_pad % block_t == 0, (t_pad, block_t)
    i32 = torch.int32
    order = torch.argsort(cls, stable=True).to(i32)
    cls_sorted = cls[order.long()].long()
    sizes = bincount(cls, n)
    padded_sizes = (sizes + block_t - 1) // block_t * block_t
    zero = torch.zeros(1, dtype=i32, device=cls.device)
    padded_off = torch.cat([zero, torch.cumsum(padded_sizes, 0, dtype=i32)])
    start = torch.cat([zero, torch.cumsum(sizes, 0, dtype=i32)])
    rank = torch.arange(t, dtype=i32, device=cls.device) - start[cls_sorted]
    pos = padded_off[cls_sorted] + rank

    tile_starts = torch.arange(t_pad // block_t, dtype=i32,
                               device=cls.device) * block_t
    tile_cls = torch.searchsorted(padded_off[1:].contiguous(), tile_starts,
                                  right=True).clamp(0, n - 1).to(i32)
    return order, pos, tile_cls, padded_sizes, t_pad


def _serving_stacks(x, w1, b1, w2, b2, prepadded: bool, d_out):
    """Kernel-form stacks (lane-padded, biases (n, 1, d)) and the logical
    output width."""
    if prepadded:
        assert d_out is not None, "prepadded stacks need an explicit d_out"
        assert x.shape[1] <= w1.shape[1], (x.shape, w1.shape)
        return w1, b1[:, None, :], w2, b2[:, None, :], d_out
    w1p, b1p, w2p, b2p = prepad_switched_weights(w1, b1, w2, b2,
                                                 pseudo_classes=0)
    return w1p, b1p[:, None, :], w2p, b2p[:, None, :], w2.shape[2]


def _sort_plan(cls, n, block_t, sort_plan):
    if sort_plan is None:
        order, pos, tile_cls, _, t_pad = class_sort_plan(cls, n, block_t)
    else:
        order, pos, tile_cls = sort_plan
        t_pad = tile_cls.shape[0] * block_t
    return order, pos, tile_cls, t_pad


def _sorted_rows(x, order, pos, t_pad: int, d_in_p: int) -> torch.Tensor:
    """Rows of ``x`` at their class-sorted padded positions, zeros
    elsewhere: the switched kernel's (t_pad, d_in_p) input."""
    xp = x.new_zeros((t_pad, d_in_p))
    xp[pos.long(), :x.shape[1]] = x[order.long()]
    return xp


def kernel_operands(x: torch.Tensor, cls: torch.Tensor, w1, b1, w2, b2, *,
                    block_t: int):
    """Both kernels' operands for one dispatch, built as
    ``switched_apply`` and ``switched_apply_fused`` build them.

    Returns ``(xp, rows, tile_cls, (w1p, b1p, w2p, b2p), order, pos)``:
    the class-sorted padded rows, the fused kernel's row index, the
    per-tile class, the stacks in kernel form and the sort plan."""
    w1p, b1p, w2p, b2p, _ = _serving_stacks(x, w1, b1, w2, b2, False, None)
    order, pos, tile_cls, _, t_pad = class_sort_plan(cls, w1.shape[0],
                                                     block_t)
    xp = _sorted_rows(x, order, pos, t_pad, w1p.shape[1])
    rows = fused_dispatch.fused_row_index(order, pos, x.shape[0], t_pad)
    return xp, rows, tile_cls, (w1p, b1p, w2p, b2p), order, pos


def switched_apply(x: torch.Tensor, cls: torch.Tensor, w1, b1, w2, b2, *,
                   block_t: int = 256, prepadded: bool = False,
                   d_out: int | None = None, sort_plan=None) -> torch.Tensor:
    """MCMA dispatch: row t is evaluated under approximator cls[t].

    x: (T, d_in); cls: (T,) int32 in [0, n).  Rows are grouped by class into
    single-class tiles (worst-case padding: one partial tile per class), the
    switched kernel runs over the padded buffer, and results scatter back.

    ``prepadded=True`` declares the weight stacks already in serving form
    (prepad_switched_weights) so no per-call weight copies happen; ``d_out``
    then gives the LOGICAL output width.  ``sort_plan`` is an optional
    precomputed ``(order, pos, tile_cls)`` from ``class_sort_plan(cls, n,
    block_t)``; ``cls`` is ignored when it is given.
    """
    w1p, b1p, w2p, b2p, d_out = _serving_stacks(x, w1, b1, w2, b2,
                                                prepadded, d_out)
    order, pos, tile_cls, t_pad = _sort_plan(cls, w1.shape[0], block_t,
                                             sort_plan)
    xp = _sorted_rows(x, order, pos, t_pad, w1p.shape[1])
    yp = switched_mlp.switched_mlp(xp, tile_cls, w1p, b1p, w2p, b2p,
                                   block_t=block_t)
    order, pos = order.long(), pos.long()
    out = x.new_zeros((x.shape[0], d_out))
    out[order] = yp[pos, :d_out]
    return out


def switched_apply_fused(x: torch.Tensor, cls: torch.Tensor, w1, b1, w2, b2,
                         *, block_t: int = 256, prepadded: bool = False,
                         d_out: int | None = None,
                         sort_plan=None) -> torch.Tensor:
    """``switched_apply`` with the gather/scatter fused into the kernel:
    same contract and bit-identical results, but the class-sort
    permutation rides into the kernel as a row-index vector."""
    t = x.shape[0]
    w1p, b1p, w2p, b2p, d_out = _serving_stacks(x, w1, b1, w2, b2,
                                                prepadded, d_out)
    order, pos, tile_cls, t_pad = _sort_plan(cls, w1.shape[0], block_t,
                                             sort_plan)
    rows = fused_dispatch.fused_row_index(order, pos, t, t_pad)
    y = fused_dispatch.switched_mlp_fused(x.contiguous(), rows, tile_cls,
                                          w1p, b1p, w2p, b2p,
                                          block_t=block_t)
    return y[:t, :d_out]
