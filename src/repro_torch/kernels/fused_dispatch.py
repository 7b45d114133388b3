"""Fused dispatch: the weight-switch MLP with the class-sort gather and
scatter folded into the kernel's row load and store.

Replaces the Pallas TPU kernel ``repro/kernels/fused_dispatch.py``
(``switched_mlp_fused``, bodies ``_fused_kernel`` and the row index of
``fused_row_index``).  On Hopper it is ``csrc/fused_dispatch.cu``: the
same tile compute as ``csrc/switched_mlp.cu`` (both call
``csrc/switch_tile.cuh``), with each padded position's row read from x
through ``rows`` and its result stored straight to that original row, so
the activations cross device memory once per layer.  The TPU kernel's
limit that the whole activation block fit VMEM has no counterpart here:
rows are gathered per row block, and a row block of padding only is
skipped.  Bound at the decode path's shape: the weight bytes; PERF.md has
the measured times.

``switched_mlp_fused`` launches the kernel for CUDA tensors and counts
each call in ``switched_mlp_fused.launches``; for CPU tensors it runs
``switched_mlp_fused_plain``.  Any other device raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.switched_mlp import check_cuda_args, tile_math

_ENTRIES = {"switched_mlp_fused_f32": (8, 7),
            "switched_mlp_fused_bf16": (8, 7)}


def fused_row_index(order: torch.Tensor, pos: torch.Tensor, t: int,
                    t_pad: int) -> torch.Tensor:
    """Fold a class-sort permutation into the kernel's row-index vector.

    ``(order, pos)`` come from ops.class_sort_plan (original row
    ``order[k]`` lands at padded position ``pos[k]``).  Returns a (t_pad,)
    int32 vector mapping each padded position to its ORIGINAL row — both
    the gather source on load and the scatter destination on store —
    with padding positions holding the trash id ``t``.
    """
    rows = torch.full((t_pad,), t, dtype=torch.int32, device=order.device)
    rows[pos.long()] = order.to(torch.int32)
    return rows


def switched_mlp_fused_plain(x, rows, tile_cls, w1, b1, w2, b2, *,
                             block_t: int = 256):
    """PyTorch version of the fused kernel (same signature and tile math)."""
    t, d_in = x.shape
    d_in_p = w1.shape[1]
    xs = F.pad(x[rows.clamp(max=t - 1).long()], (0, d_in_p - d_in))
    y = tile_math(xs, tile_cls, w1, b1, w2, b2, block_t=block_t)
    out = torch.empty((t + 1, y.shape[1]), dtype=x.dtype, device=x.device)
    out[rows.long()] = y
    return out


def switched_mlp_fused(x: torch.Tensor, rows: torch.Tensor,
                       tile_cls: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       *, block_t: int = 256) -> torch.Tensor:
    """Fused grouped MLP over UNSORTED rows via a row index.

    x: (T, d_in) in ORIGINAL row order; rows: (t_pad,) int32 row index
    from ``fused_row_index`` (t_pad % block_t == 0, every block_t tile
    single-class); tile_cls: (t_pad // block_t,) int32 per-tile class;
    w1: (n, d_in_p, d_h_p); b1: (n, 1, d_h_p); w2: (n, d_h_p, d_out_p);
    b2: (n, 1, d_out_p) — feature dims may exceed x's (lane padding).

    Returns (T + 1, d_out_p): row r of the input's result at row r, the
    trash row last — callers slice ``[:T, :d_out]``.
    """
    t, d_in = x.shape
    assert t >= 1, "fused dispatch needs at least one row"
    d_in_p, d_h_p = w1.shape[1], w1.shape[2]
    d_out_p = w2.shape[2]
    assert d_in <= d_in_p, (d_in, d_in_p)
    t_pad = rows.shape[0]
    assert t_pad % block_t == 0, (t_pad, block_t)
    assert tile_cls.shape == (t_pad // block_t,), (tile_cls.shape, t_pad)
    if x.device.type == "cpu":
        return switched_mlp_fused_plain(x, rows, tile_cls, w1, b1, w2, b2,
                                        block_t=block_t)
    if x.device.type != "cuda":
        raise ValueError(f"switched_mlp_fused: no kernel for device "
                         f"{x.device}")
    sfx = check_cuda_args(x, (rows, tile_cls), (w1, b1, w2, b2),
                          block_t=block_t, name="switched_mlp_fused")
    out = torch.empty((t + 1, d_out_p), dtype=x.dtype, device=x.device)
    lib = build.load("fused_dispatch", _ENTRIES)
    err = getattr(lib, f"switched_mlp_fused_{sfx}")(
        x.data_ptr(), rows.data_ptr(), tile_cls.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), t, d_in,
        t_pad, d_in_p, d_h_p, d_out_p, block_t,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"switched_mlp_fused: kernel launch failed with "
                           f"CUDA error {err}")
    switched_mlp_fused.launches += 1
    return out


switched_mlp_fused.launches = 0
