"""Exact implementations of the eight target functions, on tensors
(counterpart of ``repro/apps/functions.py``).

These are the "CPU" paths that approximate computing replaces.  All take
float32 tensors of shape (n, d_in) and return (n, d_out), computed with
the reference's operations in the reference's order.
"""
from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# 1. Black-Scholes (6 inputs: spot, strike, rate, dividend, vol, time -> call)
# ---------------------------------------------------------------------------


def _ncdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def blackscholes(x: torch.Tensor) -> torch.Tensor:
    s, k, r, q, vol, t = [x[:, i] for i in range(6)]
    vol = vol.clamp(min=1e-3)
    t = t.clamp(min=1e-3)
    srt = vol * torch.sqrt(t)
    d1 = (torch.log(s / k) + (r - q + 0.5 * vol * vol) * t) / srt
    d2 = d1 - srt
    call = s * torch.exp(-q * t) * _ncdf(d1) \
        - k * torch.exp(-r * t) * _ncdf(d2)
    return call[:, None]


# ---------------------------------------------------------------------------
# 2. FFT twiddle (1 input -> (re, im) of exp(-2*pi*i * w * x))
# ---------------------------------------------------------------------------

_FFT_FREQ = 16.0


def fft_twiddle(x: torch.Tensor) -> torch.Tensor:
    ang = -2.0 * math.pi * _FFT_FREQ * x[:, 0]
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


# ---------------------------------------------------------------------------
# 3. inversek2j: 2-joint arm inverse kinematics (x, y) -> (theta1, theta2)
# ---------------------------------------------------------------------------

_L1, _L2 = 0.5, 0.5


def inversek2j(x: torch.Tensor) -> torch.Tensor:
    px, py = x[:, 0], x[:, 1]
    r2 = px * px + py * py
    c2 = ((r2 - _L1 * _L1 - _L2 * _L2) / (2 * _L1 * _L2)).clamp(-1.0, 1.0)
    t2 = torch.arccos(c2)
    t1 = torch.atan2(py, px) - torch.atan2(_L2 * torch.sin(t2),
                                           _L1 + _L2 * torch.cos(t2))
    return torch.stack([t1, t2], dim=-1)


# ---------------------------------------------------------------------------
# 4. jmeint: triangle-triangle intersection (18 inputs -> one-hot 2 classes)
#    by the separating-axis test over 11 candidate axes
# ---------------------------------------------------------------------------

def _project(tri, axis):
    # tri: (n, 3, 3); axis: (n, 3) -> (min, max) over vertices
    d = torch.einsum("nvk,nk->nv", tri, axis)
    return d.amin(dim=1), d.amax(dim=1)


def _sat_separated(t1, t2, axis):
    # True where ``axis`` separates the triangles
    mn1, mx1 = _project(t1, axis)
    mn2, mx2 = _project(t2, axis)
    degenerate = (axis * axis).sum(-1) < 1e-12
    return torch.where(degenerate, False, (mx1 < mn2) | (mx2 < mn1))


def jmeint(x: torch.Tensor) -> torch.Tensor:
    t1 = x[:, :9].reshape(-1, 3, 3)
    t2 = x[:, 9:].reshape(-1, 3, 3)
    e1 = torch.stack([t1[:, 1] - t1[:, 0], t1[:, 2] - t1[:, 1],
                      t1[:, 0] - t1[:, 2]], dim=1)
    e2 = torch.stack([t2[:, 1] - t2[:, 0], t2[:, 2] - t2[:, 1],
                      t2[:, 0] - t2[:, 2]], dim=1)
    n1 = torch.linalg.cross(e1[:, 0], e1[:, 1])
    n2 = torch.linalg.cross(e2[:, 0], e2[:, 1])
    sep = _sat_separated(t1, t2, n1) | _sat_separated(t1, t2, n2)
    for i in range(3):
        for j in range(3):
            axis = torch.linalg.cross(e1[:, i], e2[:, j])
            sep = sep | _sat_separated(t1, t2, axis)
    intersect = (~sep).to(torch.float32)
    return torch.stack([1.0 - intersect, intersect], dim=-1)   # one-hot


# ---------------------------------------------------------------------------
# 5. JPEG: 8x8 block lossy roundtrip IDCT(quant(DCT(block))) (64 -> 64)
# ---------------------------------------------------------------------------

def _dct_matrix(n=8, device=None):
    k = torch.arange(n, device=device)[:, None].to(torch.float32)
    i = torch.arange(n, device=device)[None, :].to(torch.float32)
    m = math.sqrt(2.0 / n) * torch.cos(math.pi * (2 * i + 1) * k / (2 * n))
    m[0] *= 1.0 / torch.sqrt(torch.tensor(2.0, device=device))
    return m


# Standard JPEG luminance quantization table.
_QTAB = (
    (16, 11, 10, 16, 24, 40, 51, 61),
    (12, 12, 14, 19, 26, 58, 60, 55),
    (14, 13, 16, 24, 40, 57, 69, 56),
    (14, 17, 22, 29, 51, 87, 80, 62),
    (18, 22, 37, 56, 68, 109, 103, 77),
    (24, 35, 55, 64, 81, 104, 113, 92),
    (49, 64, 78, 87, 103, 121, 120, 101),
    (72, 92, 95, 98, 112, 100, 103, 99))


def jpeg_block(x: torch.Tensor) -> torch.Tensor:
    blocks = x.reshape(-1, 8, 8) * 255.0 - 128.0
    d = _dct_matrix(device=x.device)
    qtab = torch.tensor(_QTAB, dtype=torch.float32, device=x.device)
    coef = torch.einsum("ij,njk,lk->nil", d, blocks, d)
    q = torch.round(coef / qtab) * qtab
    rec = torch.einsum("ji,njk,kl->nil", d, q, d)
    return ((rec + 128.0) / 255.0).reshape(-1, 64)


# ---------------------------------------------------------------------------
# 6. k-means: distance between two rgb points (6 -> 1), the NPU kernel
# ---------------------------------------------------------------------------

def kmeans_dist(x: torch.Tensor) -> torch.Tensor:
    a, b = x[:, :3], x[:, 3:]
    return torch.sqrt(((a - b) ** 2).sum(-1, keepdim=True) + 1e-12)


# ---------------------------------------------------------------------------
# 7. sobel: 3x3 patch -> gradient magnitude (9 -> 1)
# ---------------------------------------------------------------------------

_GX = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))


def sobel(x: torch.Tensor) -> torch.Tensor:
    gx_k = torch.tensor(_GX, dtype=torch.float32, device=x.device)
    p = x.reshape(-1, 3, 3)
    gx = (p * gx_k).sum(dim=(1, 2))
    gy = (p * gx_k.T).sum(dim=(1, 2))
    return (torch.sqrt(gx * gx + gy * gy) / 4.0).clamp(0.0, 1.0)[:, None]


# ---------------------------------------------------------------------------
# 8. Bessel: (x, y) -> J0(x) * J1(y)
# ---------------------------------------------------------------------------

def _j0(x):
    """Bessel J0 via Abramowitz & Stegun 9.4.1/9.4.3 rational
    approximations."""
    ax = x.abs()
    t = (x / 3.0) ** 2
    small = (1.0 - 2.2499997 * t + 1.2656208 * t**2 - 0.3163866 * t**3
             + 0.0444479 * t**4 - 0.0039444 * t**5 + 0.0002100 * t**6)
    z = 3.0 / ax.clamp(min=1e-9)
    f0 = (0.79788456 - 0.00000077 * z - 0.00552740 * z**2
          - 0.00009512 * z**3 + 0.00137237 * z**4 - 0.00072805 * z**5
          + 0.00014476 * z**6)
    t0 = (ax - 0.78539816 - 0.04166397 * z - 0.00003954 * z**2
          + 0.00262573 * z**3 - 0.00054125 * z**4 - 0.00029333 * z**5
          + 0.00013558 * z**6)
    big = f0 * torch.cos(t0) / torch.sqrt(ax.clamp(min=1e-9))
    return torch.where(ax <= 3.0, small, big)


def _j1(x):
    """Bessel J1 via Abramowitz & Stegun 9.4.4/9.4.6."""
    ax = x.abs()
    t = (x / 3.0) ** 2
    small = x * (0.5 - 0.56249985 * t + 0.21093573 * t**2
                 - 0.03954289 * t**3 + 0.00443319 * t**4
                 - 0.00031761 * t**5 + 0.00001109 * t**6)
    z = 3.0 / ax.clamp(min=1e-9)
    f1 = (0.79788456 + 0.00000156 * z + 0.01659667 * z**2
          + 0.00017105 * z**3 - 0.00249511 * z**4 + 0.00113653 * z**5
          - 0.00020033 * z**6)
    t1 = (ax - 2.35619449 + 0.12499612 * z + 0.00005650 * z**2
          - 0.00637879 * z**3 + 0.00074348 * z**4 + 0.00079824 * z**5
          - 0.00029166 * z**6)
    big = torch.sign(x) * f1 * torch.cos(t1) / torch.sqrt(ax.clamp(min=1e-9))
    return torch.where(ax <= 3.0, small, big)


def bessel(x: torch.Tensor) -> torch.Tensor:
    return (_j0(x[:, 0]) * _j1(x[:, 1]))[:, None]
