"""Analytical NPU performance/energy model (paper Fig. 8; counterpart of
``repro/core/npu_model.py``, plain Python).

The paper estimates MCMA performance "by scaling the performance of NPU
based on the invocation of NPU"; this does the same with an explicit model:

  T(method) = T_cls + inv * T_npu(A) + (1 - inv) * T_cpu
  E(method) = E_cls + inv * E_npu(A) + (1 - inv) * E_cpu

* NPU: 8 PEs per tile, 1 MAC/cycle/PE -> T_npu = MACs/8 + FIFO latency.
* CPU cost per call = per-app dynamic-instruction constants (registry).
* Energy: CPU ~ 1.0 nJ per cycle-op at nominal; NPU MAC ~ 0.03 nJ.
* MCMA weight switch: Case 1/3 of paper §III-D — swap overlaps compute, so
  switching cost is 0 when all approximators fit the weight buffer and one
  reload otherwise; ``switch_penalty`` cycles are charged on a class change.

MCCA pays one classifier inference per consulted pair (its serial weakness);
MCMA pays exactly one (multiclass) classifier inference.  These are the
model's cycles and nanojoules, not a measurement of any device.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

from repro_torch.core.mlp import MLPSpec

if TYPE_CHECKING:  # avoid circular import (apps imports core.mlp)
    from repro_torch.apps.registry import App

N_PES = 8.0
FIFO_LATENCY = 8.0            # cycles per NN inference, bus/FIFO overhead
CPU_ENERGY_PER_CYCLE = 1.0    # nJ
NPU_ENERGY_PER_MAC = 0.03     # nJ
NPU_ENERGY_STATIC = 2.0       # nJ per inference (FIFO/bus/controller)
WEIGHT_BUFFER_MACS = 4096     # capacity (weights) of the per-PE buffers x tile


def nn_cycles(spec: MLPSpec) -> float:
    return spec.n_macs / N_PES + FIFO_LATENCY


def nn_energy(spec: MLPSpec) -> float:
    return spec.n_macs * NPU_ENERGY_PER_MAC + NPU_ENERGY_STATIC


@dataclasses.dataclass(frozen=True)
class CostReport:
    time_per_call: float
    energy_per_call: float

    def speedup_vs(self, other: "CostReport") -> float:
        return other.time_per_call / self.time_per_call

    def energy_reduction_vs(self, other: "CostReport") -> float:
        return other.energy_per_call / self.energy_per_call


def cost(app: "App", invocation: float, *, n_approx: int = 1,
         n_classifier_calls: float = 1.0, multiclass: bool = False,
         switch_rate: float = 0.0) -> CostReport:
    """Expected per-call time (cycles) and energy (nJ) for a method.

    ``switch_rate``: probability consecutive inputs use different
    approximators (charges a weight reload when the buffer cannot hold all
    approximators — paper §III-D Case 3).
    """
    aspec = app.approx_spec
    cspec = app.cls_spec(n_approx + 1 if multiclass else 2)
    t_cls = n_classifier_calls * nn_cycles(cspec)
    e_cls = n_classifier_calls * nn_energy(cspec)
    all_fit = n_approx * aspec.n_macs <= WEIGHT_BUFFER_MACS
    switch_penalty = 0.0 if all_fit else aspec.n_macs / N_PES  # reload
    t_approx = nn_cycles(aspec) + switch_rate * switch_penalty
    t = t_cls + invocation * t_approx + (1.0 - invocation) * app.cpu_cycles
    e = (e_cls + invocation * nn_energy(aspec)
         + (1.0 - invocation) * app.cpu_cycles * CPU_ENERGY_PER_CYCLE)
    return CostReport(t, e)


def cpu_only(app: "App") -> CostReport:
    return CostReport(app.cpu_cycles, app.cpu_cycles * CPU_ENERGY_PER_CYCLE)
