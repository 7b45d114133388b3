"""The port's kernels: hand-written CUDA C++ for sm_90a under csrc/,
each with its PyTorch version and launch counter beside its wrapper."""
