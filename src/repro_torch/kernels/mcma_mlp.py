"""Fused 2-layer MLP forward for one approximator (the approximator hot
path, the paper's NPU approximator).

Replaces the Pallas TPU kernel ``repro/kernels/mcma_mlp.py``
(``mlp_forward``, body ``_mlp_kernel``).  On Hopper it is the CUDA C++
kernel ``csrc/mcma_mlp.cu``, built for ``sm_90a`` and bound with
``ctypes`` (kernels/build.py): the weight-switch tile routine of
``csrc/switch_tile.cuh`` with a single class.  The TPU kernel keeps both
weight matrices resident in VMEM across its row grid; here each 32-row
block's cluster of 8 CTAs streams its slices of both through L2.  PERF.md
has the measured times.

``mlp_forward`` launches the kernel for CUDA tensors and counts each
launch in ``mlp_forward.launches``; for CPU tensors it runs
``mlp_forward_plain``, the weight-switch tile math with one class.  Any
other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.switched_mlp import check_cuda_args, tile_math

_ENTRIES = {"mlp_forward_f32": (6, 5), "mlp_forward_bf16": (6, 5)}


def _one_class(w1, b1, w2, b2):
    """The weights as one-class stacks, the weight-switch kernels' form."""
    return w1[None], b1.reshape(1, 1, -1), w2[None], b2.reshape(1, 1, -1)


def mlp_forward_plain(x, w1, b1, w2, b2, *, block_t: int = 256):
    """PyTorch version of the kernel (same signature and tile math)."""
    assert x.shape[0] % block_t == 0, (x.shape, block_t)
    tile_cls = torch.zeros(x.shape[0] // block_t, dtype=torch.int32,
                           device=x.device)
    return tile_math(x, tile_cls, *_one_class(w1, b1, w2, b2),
                     block_t=block_t)


def mlp_forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, *,
                block_t: int = 256) -> torch.Tensor:
    """Fused MLP forward.  All dims must already be tile-aligned
    (T % block_t == 0; feature dims % 128 == 0) — see ops.mlp_apply.

    x: (T, d_in); w1: (d_in, d_h); b1: (d_h,) or (1, d_h);
    w2: (d_h, d_out); b2: (d_out,) or (1, d_out).  Returns (T, d_out) in
    x's dtype: ``(tanh(x·w1 + b1) -> x.dtype)·w2 + b2`` with f32 sums.
    """
    t, d_in = x.shape
    assert t % block_t == 0, (t, block_t)
    assert w1.shape[0] == d_in and w2.shape[0] == w1.shape[1], (
        x.shape, w1.shape, w2.shape)
    assert b1.numel() == w1.shape[1] and b2.numel() == w2.shape[1], (
        b1.shape, b2.shape)
    if x.device.type == "cpu":
        return mlp_forward_plain(x, w1, b1, w2, b2, block_t=block_t)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_forward: no kernel for device {x.device}")
    sfx = check_cuda_args(x, (), _one_class(w1, b1, w2, b2),
                          block_t=block_t, name="mlp_forward")
    d_h, d_out = w1.shape[1], w2.shape[1]
    out = torch.empty((t, d_out), dtype=x.dtype, device=x.device)
    lib = build.load("mcma_mlp", _ENTRIES)
    err = getattr(lib, f"mlp_forward_{sfx}")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), t, d_in, d_h, d_out, block_t,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mlp_forward: kernel launch failed with CUDA "
                           f"error {err}")
    mlp_forward.launches += 1
    return out


mlp_forward.launches = 0
