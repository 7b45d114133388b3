"""The port's kernels: hand-written CUDA C++ for sm_90a under csrc/,
each with its PyTorch version and launch counter beside its wrapper.

ops: the wrappers the serving and paper paths call (padding, class
     grouping, scatter-back).
ref: the plain PyTorch versions that define the kernels' semantics.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
