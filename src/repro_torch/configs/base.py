"""Model/run configuration schema (counterpart of ``repro/configs/base.py``).

The same dataclasses and field names as the reference, so a config pairs
one-to-one between the packages, with dtype strings mapping to torch
dtypes.  ``ApproxConfig`` has no ``interpret`` field: it selected the
Pallas interpreter on machines without a TPU, and the port's kernels have
no such mode (a CPU tensor takes the kernel's PyTorch version instead).
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    """MCMA-as-FFN: n approximators + exact fallback."""

    enable: bool = False
    n_approx: int = 3
    # approximator-library residency: 0 disables (n_approx approximators,
    # all resident).  > 0 stores a LIBRARY of library_size approximators of
    # which n_approx are resident at a time.
    library_size: int = 0
    d_hidden: int = 256          # approximator hidden width (<< d_ff)
    error_bound: float = 0.10    # relative L2 error vs the exact FFN
    scheme: str = "competitive"  # label scheme for router co-training
    router_weight: float = 0.01  # aux loss weights
    distill_weight: float = 1.0
    # serve-mode capacity fractions (of total tokens): exact path and each
    # approximator.  FLOP savings vs dense FFN = 1 - exact_frac.
    exact_frac: float = 0.5
    invoke_frac: float = 0.4
    # asymmetric per-class capacity fractions (len n_approx); () keeps the
    # shared invoke_frac for every class
    invoke_fracs: tuple = ()
    # per-request QoS tiers: static tier count, ascending bounds, default
    # per-tier exact-logit router margins
    n_tiers: int = 1
    tier_bounds: tuple = ()
    tier_margins: tuple = ()
    # per-shard capacity over-provisioning under a mesh
    shard_slack: float = 1.0
    # serve-mode dispatch engine (runtime/dispatch.py): "xla" = the eager
    # per-class oracle loop; "pallas" = the switched CUDA kernel;
    # "pallas_fused" = the fused CUDA kernel
    backend: str = "xla"
    # routing granularity: "layer" (per layer) or "tick" (one plan a tick)
    route_scope: str = "layer"
    block_t: int = 128           # dispatch row-tile size

    @property
    def n_live(self) -> int:
        """Trained approximator count: the library size when a library is
        configured, else n_approx."""
        return self.library_size or self.n_approx


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    scan_chunk: int = 32768


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    slstm_every: int = 8


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"            # FFN activation; "swiglu" = gated
    gated_ffn: bool = True
    rope_base: float = 10_000.0
    rope_pct: float = 1.0        # partial rotary
    parallel_block: bool = False # attn+FFN in parallel
    qkv_bias: bool = False
    sliding_window: int = 0      # 0 = full attention
    tie_embeddings: bool = False
    input_mode: str = "tokens"   # tokens | embeddings
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    approx: ApproxConfig = ApproxConfig()
    attn_every: int = 0
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    grad_accum: int = 1
    act_shard: str = "dp"
    q_block: int = 512
    kv_block: int = 512
    decode_flash_threshold: int = 8192

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def adtype(self) -> torch.dtype:
        return DTYPES[self.act_dtype]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
