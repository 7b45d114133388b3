"""Dynamic op counting (counterpart of ``repro/analysis/opcount.py``): the
fused-dispatch audit's measuring stick.

``count_dynamic_ops`` runs a call once under a
``torch.utils._python_dispatch.TorchDispatchMode`` and counts how many
times the named aten ops EXECUTE: a loop over layers counts once per
trip, as the reference's scan multiplier does.  The reference walks a
jaxpr; an eager call has none, so its ops are counted as they run.

Two knobs matter for the fusion audit:

  * ``min_operand_rank=2`` restricts the count to ACTIVATION-sized moves
    (gathers and scatters whose operand is a matrix), so the plan's cheap
    int32 index-vector bookkeeping does not drown the signal.
  * ``enter_kernels=False`` stops at the four kernel wrappers
    (``KERNEL_WRAPPERS``), as the reference's count stops at
    ``pallas_call``: the fused kernel's point is that its gather and
    scatter are the kernel's own row loads and stores, not standalone
    passes over device memory.  On the card a wrapper's launch is a
    ``ctypes`` call the dispatcher never sees; on the CPU the wrapper
    runs its PyTorch twin, whose ``w1[c]``, ``x[rows]`` and
    ``out[rows] = y`` ARE the kernel's I/O, so the counter suspends
    itself inside the wrappers for the duration of a count (by binding
    each module attribute, through which ``kernels/ops.py`` calls them,
    to a suspending shim; restored after: ``bind_kernel_wrappers``,
    which ``launch/hlo_cost.py`` shares).  The card's count and the
    CPU's at the same shapes are then equal.

The reference's ``sub_jaxprs`` has no counterpart: there is no program
to descend into, only the ops as they run.
"""
from __future__ import annotations

import contextlib
import importlib

# gather / scatter family by aten op name ("packet" or "packet.overload"):
# advanced indexing reads are index.Tensor, writes index_put_,
# dispatch.scatter_rows is index_add_
GATHER_OPS = frozenset({"index.Tensor", "index_select", "gather"})
SCATTER_OPS = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "index_add",
    "index_add_", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_",
})
MOVE_OPS = GATHER_OPS | SCATTER_OPS

# (module, attribute) of the four kernel wrappers: a count with
# enter_kernels=False stops at each
KERNEL_WRAPPERS = (
    ("repro_torch.kernels.switched_mlp", "switched_mlp"),
    ("repro_torch.kernels.fused_dispatch", "switched_mlp_fused"),
    ("repro_torch.kernels.mcma_mlp", "mlp_forward"),
    ("repro_torch.kernels.slstm_scan", "slstm_scan"),
)
# (module, attribute, wrapper) of the other names a wrapper is called
# through: the xLSTM layer imports ``slstm_scan`` by name
KERNEL_ALIASES = (
    ("repro_torch.models.xlstm", "slstm_scan",
     ("repro_torch.kernels.slstm_scan", "slstm_scan")),
)


def op_names(func) -> tuple[str, str]:
    """An aten op's ("packet", "packet.overload") names."""
    packet = func.overloadpacket.__name__
    return packet, f"{packet}.{func._overloadname}"


def _operand_rank(args) -> int:
    """Rank of the op's first operand (the gathered/scattered tensor)."""
    return getattr(args[0], "ndim", 0) if args else 0


def _counter(groups: dict, min_operand_rank: int):
    """A dispatch mode counting, for each {label: op names} group, the ops
    of the group that execute while it is not suspended."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = dict.fromkeys(groups, 0)
            self.suspended = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not self.suspended \
                    and _operand_rank(args) >= min_operand_rank:
                names = op_names(func)
                for label, wanted in groups.items():
                    if names[0] in wanted or names[1] in wanted:
                        self.counts[label] += 1
            return func(*args, **(kwargs or {}))

    return Counter()


@contextlib.contextmanager
def bind_kernel_wrappers(make_shim):
    """Within the block, each kernel wrapper of ``KERNEL_WRAPPERS`` is
    ``make_shim(name, real)`` under its module attribute, and under each
    name of ``KERNEL_ALIASES`` that holds it; all are put back on exit.
    A wrapper counts its launches on its module's name for it
    (``switched_mlp.launches += 1``), which is the shim meanwhile: the
    shim starts from the wrapper's count and hands it back on exit."""
    saved, shims = [], {}
    try:
        for modname, attr in KERNEL_WRAPPERS:
            mod = importlib.import_module(modname)
            real = getattr(mod, attr)
            shim = make_shim(attr, real)
            shim.launches = getattr(real, "launches", 0)
            saved.append((mod, attr, real, shim))
            shims[modname, attr] = (real, shim)
            setattr(mod, attr, shim)
        for modname, attr, target in KERNEL_ALIASES:
            mod = importlib.import_module(modname)
            real, shim = shims[target]
            if getattr(mod, attr) is real:
                saved.append((mod, attr, real, None))
                setattr(mod, attr, shim)
        yield
    finally:
        for mod, attr, real, shim in reversed(saved):
            if shim is not None and hasattr(real, "launches"):
                real.launches = shim.launches
            setattr(mod, attr, real)


def kernels_opaque(counter):
    """Within the block, each kernel wrapper suspends ``counter`` while it
    runs (``bind_kernel_wrappers``)."""
    def make_shim(name, real):
        def opaque(*a, **k):
            counter.suspended += 1
            try:
                return real(*a, **k)
            finally:
                counter.suspended -= 1
        return opaque
    return bind_kernel_wrappers(make_shim)


def count_ops(fn, args, groups: dict, *, kwargs=None,
              min_operand_rank: int = 0,
              enter_kernels: bool = False) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return ``{label: executions}``
    for each ``{label: op names}`` group."""
    counter = _counter(groups, min_operand_rank)
    stop = contextlib.nullcontext() if enter_kernels \
        else kernels_opaque(counter)
    with stop, counter:
        fn(*args, **(kwargs or {}))
    return counter.counts


def count_dynamic_ops(fn, args, names, *, kwargs=None,
                      min_operand_rank: int = 0,
                      enter_kernels: bool = False) -> int:
    """How many times ops in ``names`` EXECUTE in one call of ``fn``."""
    return count_ops(fn, args, {"ops": frozenset(names)}, kwargs=kwargs,
                     min_operand_rank=min_operand_rank,
                     enter_kernels=enter_kernels)["ops"]


def activation_moves(fn, args, kwargs=None) -> tuple[int, int]:
    """(standalone gathers, standalone scatters) over activation-sized
    (rank >= 2) operands in one call of ``fn``, kernel wrappers excluded:
    the fusion audit's headline numbers.  Under ``backend="pallas_fused"``
    a layer's execute shows (1, 1), the exact path's capacity buffer;
    unfused "pallas" adds the class-sort gather and inverse scatter."""
    c = count_ops(fn, args, {"gathers": GATHER_OPS,
                             "scatters": SCATTER_OPS}, kwargs=kwargs,
                  min_operand_rank=2)
    return c["gathers"], c["scatters"]
