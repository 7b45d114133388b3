"""The sLSTM recurrence over a whole sequence, with the state on chip.

Replaces the Pallas TPU kernel ``repro/kernels/slstm_scan.py``
(``slstm_scan``, body ``_slstm_kernel``), which runs the whole time loop
as a sequential grid with the state (h, c, n, m) resident in VMEM.  On
Hopper it is the CUDA C++ kernel ``csrc/slstm_scan.cu``, built for
``sm_90a`` and bound with ``ctypes`` (kernels/build.py): one launch runs
all S steps, one CTA per (batch row, head) with that head's state in
shared memory, since the recurrence is block-diagonal per head and the
batch rows are independent.  PERF.md has the measured times.

Stabilized cell (the module docstring of the reference kernel):
  z = tanh(gz)   o = sigmoid(go)
  m' = max(log_sigmoid(gf) + m, min(gi, I_CLAMP))
  c' = exp(log_sigmoid(gf) + m - m') c + exp(min(gi, I_CLAMP) - m') z
  n' = exp(log_sigmoid(gf) + m - m') n + exp(min(gi, I_CLAMP) - m')
  h' = o * c' / max(n', 1e-6)
with ``g = xg[t] + (h -> wh.dtype)·wh[head]`` summed in f32.

``slstm_scan`` launches the kernel for CUDA tensors and counts each launch
in ``slstm_scan.launches``; for CPU tensors it runs ``slstm_scan_plain``,
the same arithmetic step by step in PyTorch.  Any other device raises.
The forward only: training's backward (a recompute through the reference
scan, the reference's ``slstm_scan_trainable``) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

I_CLAMP = 8.0

_ENTRIES = {"slstm_scan_f32": (11, 4), "slstm_scan_bf16": (11, 4)}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SMEM_BYTES = 48 * 1024      # static launch limit: 5 state rows of hd f32


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The kernel's formula: min(x, 0) - log1p(exp(-|x|))."""
    return x.clamp(max=0) - torch.log1p(torch.exp(-x.abs()))


def slstm_scan_plain(xg, wh, h0, c0, n0, m0):
    """PyTorch version of the kernel (same signature and arithmetic): ``h``
    is rounded to ``wh.dtype`` and the recurrent product summed in f32."""
    hd = xg.shape[-1] // 4
    w = wh.float()
    hp, cp, np_, mp = h0, c0, n0, m0
    ys = []
    for t in range(xg.shape[0]):
        rec = torch.einsum("bhi,hio->bho", hp.to(wh.dtype).float(), w)
        gz, gi, gf, go = (xg[t] + rec).split(hd, dim=-1)
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        log_f = _log_sigmoid(gf)
        i_pre = gi.clamp(max=I_CLAMP)
        m = torch.maximum(log_f + mp, i_pre)
        i_s = torch.exp(i_pre - m)
        f_s = torch.exp(log_f + mp - m)
        cp = f_s * cp + i_s * z
        np_ = f_s * np_ + i_s
        hp = o * cp / np_.clamp(min=1e-6)
        mp = m
        ys.append(hp)
    return torch.stack(ys), (hp, cp, np_, mp)


def _check_cuda_args(xg, wh, states):
    if wh.dtype not in _SUFFIX:
        raise TypeError(f"slstm_scan: wh dtype {wh.dtype} is not "
                        "float32/bfloat16")
    for a in (xg, *states):
        if a.dtype != torch.float32:
            raise TypeError(f"slstm_scan: xg and the states must be float32, "
                            f"got {a.dtype}")
    for a in (xg, wh, *states):
        if a.device != xg.device:
            raise ValueError(f"slstm_scan: tensors on {a.device} and "
                             f"{xg.device}")
        if not a.is_contiguous():
            raise ValueError(f"slstm_scan: non-contiguous input "
                             f"{tuple(a.shape)}")
    hd = wh.shape[1]
    if 5 * hd * 4 > _SMEM_BYTES:
        raise ValueError(f"slstm_scan: head dim {hd} needs more than "
                         f"{_SMEM_BYTES} B of shared memory")
    return _SUFFIX[wh.dtype]


def slstm_scan(xg: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor):
    """Run the sLSTM over a sequence.

    xg: (S, B, H, 4*hd) f32 — input-side gate pre-activations (bias
    included), gate order [z|i|f|o] per head; wh: (H, hd, 4*hd) recurrent
    weights (f32 or bf16); h0/c0/n0/m0: (B, H, hd) f32.
    Returns (ys (S, B, H, hd) f32, (hf, cf, nf, mf)).
    """
    s, b, h, hd4 = xg.shape
    assert hd4 % 4 == 0, (
        f"xg last dim must stack the 4 gate pre-activations, got {hd4}")
    hd = hd4 // 4
    assert s >= 1, "slstm_scan needs at least one step"
    assert wh.shape == (h, hd, hd4), (wh.shape, xg.shape)
    states = (h0, c0, n0, m0)
    for st in states:
        assert st.shape == (b, h, hd), (st.shape, xg.shape)
    if xg.device.type == "cpu":
        return slstm_scan_plain(xg, wh, *states)
    if xg.device.type != "cuda":
        raise ValueError(f"slstm_scan: no kernel for device {xg.device}")
    sfx = _check_cuda_args(xg, wh, states)
    ys = torch.empty((s, b, h, hd), dtype=torch.float32, device=xg.device)
    finals = [torch.empty((b, h, hd), dtype=torch.float32, device=xg.device)
              for _ in range(4)]
    lib = build.load("slstm_scan", _ENTRIES)
    err = getattr(lib, f"slstm_scan_{sfx}")(
        xg.data_ptr(), wh.data_ptr(), *(a.data_ptr() for a in states),
        ys.data_ptr(), *(a.data_ptr() for a in finals), s, b, h, hd,
        torch.cuda.current_stream(xg.device).cuda_stream)
    if err:
        raise RuntimeError(f"slstm_scan: kernel launch failed with CUDA "
                           f"error {err}")
    slstm_scan.launches += 1
    return ys, tuple(finals)


slstm_scan.launches = 0
