"""Core: the paper's contribution (counterpart of ``repro/core``) —
approximators, classifiers, co-training methods (one-pass / iterative /
MCCA / MCMA), quality control and the NPU cost model.
"""
from repro_torch.core.mlp import (MLPSpec, apply_mlp, init_mlp, mlp_logits,
                                  train_mlp)
from repro_torch.core.onepass import BinaryPair, train_one_pass
from repro_torch.core.iterative import train_iterative
from repro_torch.core.mcca import MCCA, train_mcca
from repro_torch.core.mcma import MCMA, train_mcma
from repro_torch.core import npu_model, quality

__all__ = [
    "MLPSpec", "apply_mlp", "init_mlp", "mlp_logits", "train_mlp",
    "BinaryPair", "train_one_pass", "train_iterative",
    "MCCA", "train_mcca", "MCMA", "train_mcma", "npu_model", "quality",
]
