"""The weight-switch kernels' shape sweeps, shared by the parity tests
(tests/test_torch_kernels.py) and chip_smoke.py.

They are the sweeps of the reference's tests/test_kernels.py: mixed
shapes, a skewed class mix, an empty class, T < block, one approximator,
and every row on a zero-weight class.
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
}


def case_inputs(case: str):
    """float32 numpy inputs of one sweep, from a seed fixed per case:
    ``(x, cls, [w1, b1, w2, b2], block)``."""
    t, n, d_in, d_h, d_out, block, mix = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
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
