"""Weight-switch grouped MLP over class-sorted rows (the MCMA weight switch).

Replaces the Pallas TPU kernel ``repro/kernels/switched_mlp.py``
(``switched_mlp``, body ``_switched_kernel``).  On Hopper it is a CUDA C++
kernel, ``csrc/switched_mlp.cu``, built for ``sm_90a`` and bound with
``ctypes`` (kernels/build.py).  The TPU kernel streams each tile's
approximator weights into VMEM behind the previous tile's compute; here a
cluster of 8 CTAs owns each 32-row block: each CTA computes an eighth of
the block's hidden units once, the cluster shares them through
distributed shared memory, and each CTA produces an eighth of the output
columns, its weight slices streamed through a ``cp.async`` ring (bf16 on
the tensor cores; ``csrc/switch_tile.cuh``).  At the decode path's shape
the work is bound by the weight bytes (at most n + 1 classes of (d_in_p x
d_h_p + d_h_p x d_out_p) values) rather than the arithmetic; PERF.md has
the measured times.

``switched_mlp`` launches the kernel for CUDA tensors and counts each
call in ``switched_mlp.launches``; for CPU tensors it runs
``switched_mlp_plain``, the same tile math in PyTorch.  Any other device
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_ENTRIES = {"switched_mlp_f32": (7, 5), "switched_mlp_bf16": (7, 5)}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def tile_math(xs: torch.Tensor, tile_cls: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
              block_t: int) -> torch.Tensor:
    """The kernels' per-tile arithmetic on rows already in tile order.

    xs: (t_pad, d_in_p); tile_cls: (t_pad // block_t,) int32;
    w1 (n, d_in_p, d_h_p), b1 (n, 1, d_h_p), w2 (n, d_h_p, d_out_p),
    b2 (n, 1, d_out_p).  Products and bias in f32, ``h`` rounded to
    ``xs.dtype`` before the second product (the reference kernel's cast),
    the result cast to ``xs.dtype``."""
    t_pad, d_in_p = xs.shape
    assert t_pad % block_t == 0, (t_pad, block_t)
    nt = t_pad // block_t
    c = tile_cls.long()
    xt = xs.reshape(nt, block_t, d_in_p).float()
    h = torch.bmm(xt, w1[c].float()) + b1[c].float()
    h = torch.tanh(h).to(xs.dtype).float()
    y = torch.bmm(h, w2[c].float()) + b2[c].float()
    return y.to(xs.dtype).reshape(t_pad, -1)


def switched_mlp_plain(x, tile_cls, w1, b1, w2, b2, *, block_t: int = 256):
    """PyTorch version of the kernel (same signature and tile math)."""
    assert x.shape[0] % block_t == 0, (x.shape, block_t)
    return tile_math(x, tile_cls, w1, b1, w2, b2, block_t=block_t)


# The tile routine's limits (csrc/switch_tile.cuh): feature dims in whole
# 256-byte stages and whole 16-column slices for each of the cluster's 8
# CTAs, the whole h of a 32-row block in one CTA's shared memory, row
# blocks of 16 or 32 that never straddle a tile.
FEATURE_MULTIPLE = 128
MAX_HIDDEN = 512
BLOCK_MULTIPLE = 16


def check_cuda_args(x, int_args, weights, *, block_t: int, name: str):
    """Refuse what the CUDA kernels do not take: mixed devices or dtypes,
    dtypes other than f32/bf16, non-contiguous tensors, int64 indices, and
    shapes outside the tile routine's limits."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {x.dtype} is not float32/bfloat16")
    for a in (x, *int_args, *weights):
        if a.device != x.device:
            raise ValueError(f"{name}: tensors on {a.device} and {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input {tuple(a.shape)}")
    for a in int_args:
        if a.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, "
                            f"got {a.dtype}")
    for w in weights:
        if w.dtype != x.dtype:
            raise TypeError(f"{name}: weights {w.dtype} != activations "
                            f"{x.dtype}")
        if w.data_ptr() % 16:
            raise ValueError(f"{name}: weights {tuple(w.shape)} not 16-byte "
                             "aligned (the kernels copy them 16 B at a time)")
    d_in_p, d_h_p = weights[0].shape[1], weights[0].shape[2]
    d_out_p = weights[2].shape[2]
    m = FEATURE_MULTIPLE
    if d_in_p % m or d_h_p % m or d_out_p % m:
        raise ValueError(f"{name}: feature dims (d_in {d_in_p}, d_h {d_h_p}, "
                         f"d_out {d_out_p}) must be multiples of {m}; "
                         "ops.prepad_switched_weights pads to 128")
    if d_h_p > MAX_HIDDEN:
        raise ValueError(f"{name}: d_h {d_h_p} > {MAX_HIDDEN}, more than a "
                         "CTA's shared memory holds")
    if block_t % BLOCK_MULTIPLE:
        raise ValueError(f"{name}: block_t {block_t} is not a multiple of "
                         f"{BLOCK_MULTIPLE}")
    return _SUFFIX[x.dtype]


def switched_mlp(x: torch.Tensor, tile_cls: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
                 block_t: int = 256) -> torch.Tensor:
    """Grouped MLP forward over class-sorted rows.

    x: (T, d_in) with T % block_t == 0 and every tile single-class;
    tile_cls: (T // block_t,) int32 — class of each tile;
    w1: (n, d_in, d_h); b1: (n, 1, d_h); w2: (n, d_h, d_out); b2: (n, 1, d_out).
    """
    t, d_in = x.shape
    assert t % block_t == 0, (t, block_t)
    assert tile_cls.shape == (t // block_t,), (tile_cls.shape, t, block_t)
    assert w1.shape[1] == d_in, (w1.shape, d_in)
    if x.device.type == "cpu":
        return switched_mlp_plain(x, tile_cls, w1, b1, w2, b2,
                                  block_t=block_t)
    if x.device.type != "cuda":
        raise ValueError(f"switched_mlp: no kernel for device {x.device}")
    sfx = check_cuda_args(x, (tile_cls,), (w1, b1, w2, b2), block_t=block_t,
                          name="switched_mlp")
    d_h, d_out = w1.shape[2], w2.shape[2]
    out = torch.empty((t, d_out), dtype=x.dtype, device=x.device)
    lib = build.load("switched_mlp", _ENTRIES)
    err = getattr(lib, f"switched_mlp_{sfx}")(
        x.data_ptr(), tile_cls.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), t, d_in, d_h, d_out,
        block_t, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"switched_mlp: kernel launch failed with CUDA "
                           f"error {err}")
    switched_mlp.launches += 1
    return out


switched_mlp.launches = 0
