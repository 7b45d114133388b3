"""The sLSTM recurrence over a whole sequence, with the weights on chip.

Replaces the Pallas TPU kernel ``repro/kernels/slstm_scan.py``
(``slstm_scan``, body ``_slstm_kernel``), which runs the whole time loop
as a sequential grid with the state (h, c, n, m) and the recurrent
weights resident in VMEM.  On Hopper it is the CUDA C++ kernel
``csrc/slstm_scan.cu``, built for ``sm_90a`` and bound with ``ctypes``
(kernels/build.py): one cooperative launch runs all S steps over a grid
of CTAs that each hold a slice of one head's ``wh`` (``units`` hidden
units, all four gate columns of each) in shared memory for the whole
sequence, take every batch row, 8 rows at a time, and exchange ``h``
through ``ys`` with one barrier per step among the CTAs of a head.
``plan`` chooses the split from the head count and width, the card's SM
count and its shared-memory limit; the batch changes only the number of
8-row chunks a step takes, so any batch is placed.
bf16 products run on the tensor cores, f32 ones on the CUDA cores.
PERF.md has the measured times.

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
``slstm_scan_trainable`` is the reference's ``slstm_scan_trainable``: the
forward through ``slstm_scan``, the backward a recompute through
``ref.slstm_scan_ref`` under autograd.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build, ref

I_CLAMP = 8.0

_ENTRIES = {"slstm_scan_f32": (12, 5), "slstm_scan_bf16": (12, 5)}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

THREADS = 256                  # per CTA (csrc/slstm_scan.cu kThreads)
ROWS = 8                       # batch rows per chunk (kRows)
SLOTS = 3                      # chunks of xg in the prefetch ring (kSlots)
UNITS = (8, 16, 32, 64)        # hidden units per CTA the planner tries
# bf16: at most 8 mma m-tiles of 16 gate columns (4 x 32); f32: at most
# one thread per gate column (4 x 64 = THREADS)
MAX_UNITS = {torch.bfloat16: 32, torch.float32: 64}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is split: ``units`` hidden units per CTA (all four gate
    columns of each, every batch row), ``ctas_per_head`` CTAs per head,
    ``grid`` CTAs in all, ``chunks`` chunks of ``ROWS`` batch rows per
    step, ``smem_bytes`` of dynamic shared memory each."""
    units: int
    ctas_per_head: int
    grid: int
    chunks: int
    smem_bytes: int


def smem_bytes(wdtype: torch.dtype, hd: int, units: int) -> int:
    """Dynamic shared memory of one CTA (``Layout::bytes`` in the .cu):
    the weight slice, h of one chunk of batch rows, its partial sums and a
    ring of ``SLOTS`` chunks of xg.  The batch does not enter it: the state
    (c, n, m) lives in registers, or past one chunk in the output
    buffers."""
    bf16 = wdtype == torch.bfloat16
    m = 4 * units
    kp = -(-hd // 16) * 16 if bf16 else -(-hd // 4) * 4
    esz, ldw, ldh = (2, m + 8, kp + 8) if bf16 else (4, m, kp)
    # warps (bf16) or groups of m threads (f32) of a CTA
    assert THREADS % 32 == 0 and THREADS % m == 0, (THREADS, m)
    parts = THREADS // 32 if bf16 else THREADS // m
    return (kp * ldw * esz + ROWS * ldh * esz + parts * ROWS * m * 4
            + SLOTS * ROWS * m * 4)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, hd: int, wdtype: torch.dtype, *, n_sm: int,
         smem_limit: int) -> Plan:
    """The fewest units per CTA (so the most CTAs, each with the least of
    ``wh``) for which the grid fits one CTA per SM, as the cooperative
    launch needs; raises ValueError, naming why, for a shape whose ``wh``
    cannot be placed."""
    units = [u for u in UNITS if u <= MAX_UNITS[wdtype]]
    for u in units:
        cph = -(-hd // u)
        if h * cph <= n_sm:
            break
    else:
        raise ValueError(
            f"slstm_scan: {h} heads of {hd} units need {h * -(-hd // u)} "
            f"CTAs at {u} units per CTA, more than the card's {n_sm} SMs "
            f"can hold at once")
    need = smem_bytes(wdtype, hd, u)
    if need > smem_limit:
        raise ValueError(
            f"slstm_scan: a CTA's slice of wh ({hd} x {4 * u}, {wdtype}) "
            f"and its buffers for {ROWS} batch rows need {need} B of shared "
            f"memory, more than the card's {smem_limit} B per CTA")
    return Plan(u, cph, h * cph, -(-b // ROWS), need)


def device_plan(b: int, h: int, hd: int, wdtype: torch.dtype,
                device) -> Plan:
    """``plan`` with the SM count and shared-memory limit of ``device``."""
    p = torch.cuda.get_device_properties(device)
    return plan(b, h, hd, wdtype, n_sm=p.multi_processor_count,
                smem_limit=p.shared_memory_per_block_optin)


RESOURCE_KEYS = ("registers", "static_smem", "dynamic_smem", "local_bytes",
                 "ctas_per_sm")


def resources(b: int, h: int, hd: int, wdtype: torch.dtype,
              device="cuda") -> dict[str, int]:
    """What ``cudaFuncGetAttributes`` and the occupancy query say of the
    kernel for ``wdtype`` at (b, h, hd) (``RESOURCE_KEYS``), with the
    plan's grid, CTAs per head, units per CTA and shared bytes."""
    pl = device_plan(b, h, hd, wdtype, device)
    r = build.resources("slstm_scan", "slstm_scan_resources", (
        int(wdtype == torch.bfloat16), b, hd, pl.units), RESOURCE_KEYS)
    return dict(r, grid=pl.grid, ctas_per_head=pl.ctas_per_head,
                units=pl.units, chunks=pl.chunks, plan_smem=pl.smem_bytes)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The kernel's formula: min(x, 0) - log1p(exp(-|x|))."""
    return x.clamp(max=0) - torch.log1p(torch.exp(-x.abs()))


def slstm_scan_plain(xg, wh, h0, c0, n0, m0):
    """PyTorch version of the kernel (same signature and arithmetic): ``h``
    is rounded to ``wh.dtype`` and the recurrent product summed in f32."""
    assert xg.shape[-1] % 4 == 0, xg.shape
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
    pl = device_plan(b, h, hd, wh.dtype, xg.device)
    ys = torch.empty((s, b, h, hd), dtype=torch.float32, device=xg.device)
    # (h, c, n, m) at the end; past one chunk of rows the kernel carries
    # c, n, m in them from step to step
    finals = [torch.empty((b, h, hd), dtype=torch.float32, device=xg.device)
              for _ in range(4)]
    # one arrival counter per head, zero at launch; one step has no barrier
    ctr = torch.zeros((h,), dtype=torch.int32, device=xg.device) \
        if s > 1 else None
    lib = build.load("slstm_scan", _ENTRIES)
    with torch.cuda.device(xg.device):
        err = getattr(lib, f"slstm_scan_{sfx}")(
            xg.data_ptr(), wh.data_ptr(), *(a.data_ptr() for a in states),
            ys.data_ptr(), *(a.data_ptr() for a in finals),
            None if ctr is None else ctr.data_ptr(), s, b, h, hd, pl.units,
            torch.cuda.current_stream(xg.device).cuda_stream)
    if err:
        raise RuntimeError(f"slstm_scan: kernel launch failed with CUDA "
                           f"error {err}")
    slstm_scan.launches += 1
    return ys, tuple(finals)


slstm_scan.launches = 0


class _Trainable(torch.autograd.Function):
    """Forward through ``slstm_scan``; backward by re-running the reference
    scan under autograd and pulling the cotangents through it."""

    @staticmethod
    def forward(ctx, xg, wh, h0, c0, n0, m0):
        ctx.save_for_backward(xg, wh, h0, c0, n0, m0)
        ys, finals = slstm_scan(xg, wh, h0, c0, n0, m0)
        return (ys, *finals)

    @staticmethod
    def backward(ctx, *cotangents):
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_() for a in ctx.saved_tensors]
            ys, finals = ref.slstm_scan_ref(*inputs)
            return torch.autograd.grad((ys, *finals), inputs, cotangents,
                                       allow_unused=True)


def slstm_scan_trainable(xg, wh, h0, c0, n0, m0):
    """``slstm_scan`` with gradients: the reference's custom_vjp
    (repro/kernels/slstm_scan.py ``slstm_scan_trainable``).  Same inputs
    and outputs as ``slstm_scan``."""
    ys, *finals = _Trainable.apply(xg, wh, h0, c0, n0, m0)
    return ys, tuple(finals)
