"""The kernels' shape sweeps, shared by the parity tests
(tests/test_torch_kernels.py) and chip_smoke.py.

They are the sweeps of the reference's tests/test_kernels.py.  Weight
switch: mixed shapes, a skewed class mix, an empty class, T < block, one
approximator, and every row on a zero-weight class; plus ``block16``, the
16-row tiles of tests/test_torch_dispatch.py, which take the CUDA tile
routine's 16-row blocks.  One-approximator MLP:
the four shapes of its lines 29-34.  sLSTM recurrence: the three shapes of
its lines 198-202.
"""
from __future__ import annotations

import numpy as np

# case -> (t, n, d_in, d_h, d_out, block, class mix)
CASES = {
    "mcma_default": (500, 3, 64, 32, 64, 128, "random"),
    "single_approx_sweep": (96, 1, 16, 8, 16, 32, "random"),
    "wide": (1024, 8, 128, 64, 128, 256, "random"),
    "tiny_ragged": (33, 4, 10, 6, 4, 32, "random"),
    "skewed": (257, 3, 32, 16, 32, 64, "all_last"),
    "empty_class": (120, 4, 24, 8, 24, 32, "no_class_1"),
    "t_below_block": (7, 3, 16, 8, 16, 64, "random"),
    "one_approximator": (150, 1, 20, 12, 20, 64, "random"),
    "all_nc": (90, 4, 24, 8, 24, 32, "all_last"),
    "block16": (24, 3, 32, 16, 32, 16, "random"),
}
# each case's seed: its place among the reference's sweeps, sorted, then
# the cases added after them
_SEED_ORDER = sorted(set(CASES) - {"block16"}) + ["block16"]


def case_inputs(case: str):
    """float32 numpy inputs of one sweep, from a seed fixed per case:
    ``(x, cls, [w1, b1, w2, b2], block)``."""
    t, n, d_in, d_h, d_out, block, mix = CASES[case]
    rng = np.random.default_rng(_SEED_ORDER.index(case))
    x = (rng.normal(size=(t, d_in)) * 0.5).astype(np.float32)
    w = [(rng.normal(size=s) * sc).astype(np.float32) for s, sc in (
        ((n, d_in, d_h), 0.2), ((n, d_h), 0.1), ((n, d_h, d_out), 0.2),
        ((n, d_out), 0.1))]
    if case == "all_nc":                 # last class carries zero weights
        for a in w:
            a[-1] = 0
    cls = rng.integers(0, n, t).astype(np.int32)
    if mix == "all_last":
        cls[:] = n - 1
    elif mix == "no_class_1":
        cls[cls == 1] = 3
    return x, cls, w, block


# (t, d_in, d_h, d_out)
MLP_SHAPES = [(64, 8, 8, 1), (300, 100, 40, 60), (512, 256, 128, 256),
              (1, 6, 8, 2)]


def mlp_inputs(t, d_in, d_h, d_out):
    """float32 numpy ``[x, w1, b1, w2, b2]`` from a seed fixed per shape."""
    rng = np.random.default_rng(t * 1000 + d_in)
    return [(rng.normal(size=s) * sc).astype(np.float32) for s, sc in (
        ((t, d_in), 0.5), ((d_in, d_h), 0.2), ((d_h,), 0.1),
        ((d_h, d_out), 0.2), ((d_out,), 0.1))]


# (S, B, H, hd)
SLSTM_SHAPES = [(8, 2, 2, 8), (32, 4, 4, 16), (16, 1, 4, 128)]


def slstm_inputs(s, b, h, hd, wh_scale=0.2):
    """float32 numpy ``(xg, wh, h0, c0, n0, m0)`` from a seed fixed per
    shape: zero states and m0 = -1e30, as the model starts a sequence."""
    rng = np.random.default_rng(s * 100 + b)
    xg = (rng.normal(size=(s, b, h, 4 * hd)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(h, hd, 4 * hd)) * wh_scale).astype(np.float32)
    z = np.zeros((b, h, hd), np.float32)
    return xg, wh, z, z, z, np.full((b, h, hd), -1e30, np.float32)
