"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
``device`` they take ``cuda`` and raise when there is none, instead of
dropping to the CPU quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which
    must be available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")
