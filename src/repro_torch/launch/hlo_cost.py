"""Cost model over the recorded op stream of one step (counterpart of
``repro/launch/hlo_cost.py``).

The reference walks the optimized HLO text of a compiled step,
multiplying through ``while`` trip counts.  An eager PyTorch step has no
compiled program and no loops to multiply through: ``analyze`` runs the
step once under a ``TorchDispatchMode`` and records every aten op as it
executes (a Python loop over layers is recorded once per trip), usually
on fake tensors (``FakeTensorMode``) on a fake process group, so nothing
is allocated and nothing runs on a card (``launch/dryrun.py``).  The
reference's ``Instr`` and ``parse_module`` (its HLO parser) have no
counterpart: there is no HLO text.

Models (the assumptions, as in the reference):

* FLOPs: each op's count from ``torch.utils.flop_counter``'s formulas
  (matmuls, convolutions, attention kernels); elementwise work counts 0.
* Device bytes: each materializing op's tensor inputs and outputs, each
  counted once; views, metadata ops and ``empty`` count nothing (the
  reference's ``_SKIP_BYTES``).  A collective counts its own buffers once
  (a gather's part and the parts it writes; a reduce-scatter's send and
  receive buffers); its transport (host copies, arena rounds) is not
  device traffic.  There is no fusion: every op of the stream is a pass
  over device memory, as the eager port runs it.
* Kernels are opaque.  Each of the four kernel wrappers
  (``analysis/opcount.KERNEL_WRAPPERS``) is one op, recorded with the
  work of its function (``kernels/work.wrapper_work``) and not entered:
  on a fake CUDA tensor it never reaches ``nvcc`` or a ``data_ptr``, and
  on a CPU tensor it never runs its twin's padded per-tile products.  So
  a step records the same cost on either device.
* Attention is counted, not traced.  ``models/layers.flash_attention``
  loops in Python over every (query block, key block) pair, the causal
  pairs above the diagonal included (computed, then masked): traced op
  by op a 32k-token prefill takes about 20 minutes a cell.  While
  ``analyze`` runs it is bound to ``_FlashCount``, an autograd function
  that returns an output of the right shape and dtype and records what
  the loop does (``flash_cost``: every pair it visits, its two products
  and its f32 elementwise passes) and, in the backward, what autograd
  through the loop does (``flash_backward_cost``).  Both formulas are
  held to the traced loop in the tests and on the card.
* Collective wire bytes per rank, by kind, as the port's algorithms send
  them (``sharding/collectives.WIRE``: ``all_reduce_sum`` gathers every
  part, (n-1)·payload), with the ring model's bytes beside them.  A
  collective whose group spans more than one node of ``node_size``
  ranks (rank r on node r // node_size) counts its bytes as
  ``internode_bytes``, the counterpart of the reference's cross-pod
  ``dci_bytes``.

Peak memory: a live-bytes tracker over the stream adds each new storage
an op makes when it is made and takes it away when it is freed;
``Cost.temp_peak_bytes`` is the high-water mark above the arguments.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch

# ops that move no device bytes (besides views, ``OpOverload.is_view``)
_SKIP_BYTES = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "alias", "lift_fresh", "_unsafe_view",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_local_scalar_dense", "set_", "resize_",
    "_to_copy_meta", "_assert_async", "_assert_scalar",
})
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
_METADATA_NAMESPACES = ("prim",)
# not counted as ops at all: autograd's detach of a saved output (present
# or not as saved-tensor hooks are set)
_UNCOUNTED = frozenset({"detach"})


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    # bytes of collectives whose group spans nodes (the reference's
    # dci_bytes: its pod-crossing bytes)
    internode_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    n_while: int = 0            # an eager step has no while loops
    max_trip: int = 1
    # the ring model's bytes for the same collectives, by kind
    ring_by_kind: dict = dataclasses.field(default_factory=dict)
    # {wrapper: {"calls", "bytes", "flops"}} of the opaque kernel ops
    kernels: dict = dataclasses.field(default_factory=dict)
    # the attention formula's calls, FLOPs and bytes (forward + backward)
    attention: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0
    temp_peak_bytes: int = 0


def _tensors(obj):
    """Every tensor in a nest of lists, tuples, dicts and modules."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Recorder:
    """The dispatch mode's state: the cost, the live storages and the
    suspension depth (inside an opaque kernel or attention op)."""

    def __init__(self, node_size: int, args):
        self.cost = Cost()
        self.node_size = node_size
        self.suspended = 0
        self.live = 0
        self.refs: dict = {}                 # storage key -> tensor refs
        self.sizes: dict = {}                # storage key -> bytes
        self.outside = {_storage_key(t) for t in _tensors(args)
                        if t.layout == torch.strided}

    # ---- memory ------------------------------------------------------
    def _release(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.sizes.pop(key)

    def track(self, out):
        for t in _tensors(out):
            if t.layout != torch.strided:
                continue
            key = _storage_key(t)
            if key in self.outside:
                continue
            if key not in self.refs:
                self.refs[key] = 0
                self.sizes[key] = t.untyped_storage().nbytes()
                self.live += self.sizes[key]
                self.cost.temp_peak_bytes = max(self.cost.temp_peak_bytes,
                                                self.live)
            self.refs[key] += 1
            weakref.finalize(t, self._release, key)

    # ---- costs -------------------------------------------------------
    def add(self, flops: float, nbytes: float):
        self.cost.flops += flops
        self.cost.bytes += nbytes

    def op(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        name = func.overloadpacket.__name__
        if func.namespace in _METADATA_NAMESPACES or name in _UNCOUNTED:
            return
        self.cost.n_ops += 1
        fl = flop_registry.get(func.overloadpacket)
        flops = fl(*args, **kwargs, out_val=out) if fl else 0
        if func.namespace in _COLLECTIVE_NAMESPACES or func.is_view \
                or name in _SKIP_BYTES:
            nbytes = 0
        else:
            nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in _tensors(out))
        self.add(flops, nbytes)

    def collective(self, kind, nbytes, sent, ring, ranks):
        c = self.cost
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0) + sent
        c.ring_by_kind[kind] = c.ring_by_kind.get(kind, 0) + ring
        c.wire_bytes += sent
        if len({r // self.node_size for r in ranks}) > 1:
            c.internode_bytes += sent
        n = len(ranks)
        buffers = nbytes * (n + 1) if kind in ("all_gather", "all_reduce") \
            else 2 * nbytes
        self.add(0, buffers)


def _mode(rec: _Recorder):
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.sharding import collectives

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not rec.suspended and not collectives.in_transport():
                rec.op(func, args, kwargs, out)
                rec.track(out)
            return out

    return Record()


@contextlib.contextmanager
def _suspended(rec: _Recorder):
    rec.suspended += 1
    try:
        yield
    finally:
        rec.suspended -= 1


def _kernel_outputs(name: str, args):
    """Outputs of the shape, dtype and device a kernel wrapper returns."""
    if name == "switched_mlp":
        x, w2 = args[0], args[4]
        return x.new_empty((x.shape[0], w2.shape[2]))
    if name == "switched_mlp_fused":
        x, w2 = args[0], args[5]
        return x.new_empty((x.shape[0] + 1, w2.shape[2]))
    if name == "mlp_forward":
        x, w2 = args[0], args[3]
        return x.new_empty((x.shape[0], w2.shape[1]))
    xg = args[0]                                       # slstm_scan
    s, b, h, hd4 = xg.shape
    assert hd4 % 4 == 0, xg.shape
    return (xg.new_empty((s, b, h, hd4 // 4), dtype=torch.float32),
            tuple(xg.new_empty((b, h, hd4 // 4), dtype=torch.float32)
                  for _ in range(4)))


def _kernel_shims(rec: _Recorder):
    """``opcount.bind_kernel_wrappers``'s shim maker: each call is one
    kernel op with its function's work.  On fake tensors it returns
    empty outputs of the wrapper's shapes; on real ones it runs the
    wrapper (unrecorded), so the values stay those of the step."""
    from repro_torch.kernels.work import wrapper_work

    def make_shim(name, real):
        def kernel_op(*args, **kwargs):
            nbytes, flops = wrapper_work(name, args, kwargs)
            k = rec.cost.kernels.setdefault(
                name, {"calls": 0, "bytes": 0, "flops": 0})
            k["calls"] += 1
            k["bytes"] += nbytes
            k["flops"] += flops
            rec.add(flops, nbytes)
            with _suspended(rec):
                if _is_fake(args[0]):
                    out = _kernel_outputs(name, args)
                else:
                    out = real(*args, **kwargs)
            rec.track(out)
            return out
        return kernel_op
    return make_shim


@contextlib.contextmanager
def record(*, node_size: int = 8, args=()):
    """Record every op run inside the block; yields the recorder, whose
    ``cost`` fills in as the block runs.  ``args``: the step's arguments, whose storages
    count as arguments, not as memory the step makes.  Within the block
    the kernel wrappers and ``layers.flash_attention`` are opaque (module
    docstring)."""
    from repro_torch.analysis.opcount import bind_kernel_wrappers
    from repro_torch.models import layers
    from repro_torch.sharding import collectives
    rec = _Recorder(node_size, args)
    real_flash = layers.flash_attention
    layers.flash_attention = _flash_shim(rec, real_flash)
    try:
        with bind_kernel_wrappers(_kernel_shims(rec)), \
                collectives.observe_wire(rec.collective), _mode(rec):
            yield rec
    finally:
        layers.flash_attention = real_flash


def analyze(fn, args=(), kwargs=None, *, node_size: int = 8) -> Cost:
    """The cost of one call ``fn(*args, **kwargs)``, recorded as it runs
    (``record``)."""
    with record(node_size=node_size, args=(args, kwargs)) as rec:
        fn(*args, **(kwargs or {}))
    return rec.cost


# ---------------------------------------------------------------------------
# Attention, counted (models/layers.flash_attention)
# ---------------------------------------------------------------------------

# the block counts the loop is recorded at; the last checks the fit (at
# one block the slices are the whole tensors and have no backward, so
# the polynomial starts at two)
_FIT_POINTS = (2, 3, 4, 5, 6)
_FLASH_FITS: dict = {}
_FIELDS = ("flops", "bytes", "n_ops", "held")


def _trace_flash(real, cfg, key, n: int) -> dict:
    """{"fwd": {field: value}, "bwd": ...} of the real loop over ``n``
    blocks of the key's shapes, recorded on meta tensors; ``held`` is
    what autograd keeps from the forward for the backward.  Saved
    tensors are kept as they are (a checkpointed caller's hooks would
    discard and recompute them)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily(), \
            torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
        return _trace_flash_plain(real, cfg, key, n)


def _trace_flash_plain(real, cfg, key, n: int) -> dict:
    b, h, hd, dtype, blk, causal, q_offset, grads, _, _ = key
    s = n * blk
    qkv = [torch.empty((b, s, h, hd), dtype=dtype, device="meta",
                       requires_grad=g) for g in grads]
    rec = _Recorder(8, qkv)
    with torch.enable_grad(), _mode(rec):
        out = real(cfg, *qkv, causal=causal, q_offset=q_offset)
    fwd = dict(flops=rec.cost.flops, bytes=rec.cost.bytes,
               n_ops=rec.cost.n_ops, held=rec.live - _nbytes(out))
    bwd = dict.fromkeys(_FIELDS, 0)
    if any(grads):
        g_out = torch.empty_like(out)
        want = [t for t in qkv if t.requires_grad]
        rec = _Recorder(8, (qkv, out, g_out))
        with torch.enable_grad(), _mode(rec):
            torch.autograd.grad(out, want, g_out)
        bwd.update(flops=rec.cost.flops, bytes=rec.cost.bytes,
                   n_ops=rec.cost.n_ops)
    return {"fwd": fwd, "bwd": bwd}


def _cubic_at(ys, n: int) -> int:
    """The polynomial of degree 3 through the first four fit points and
    ``ys``, evaluated at ``n`` (exact: Lagrange form over fractions)."""
    from fractions import Fraction
    xs = _FIT_POINTS[:4]
    total = Fraction(0)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        term = Fraction(yi)
        for j, xj in enumerate(xs):
            if j != i:
                term *= Fraction(n - xj, xi - xj)
        total += term
    assert total.denominator == 1, total
    return int(total)


def flash_cost(real, cfg, key, n: int) -> dict:
    """The recorded cost of ``real`` (``layers.flash_attention``) over
    ``n`` blocks of the key's shapes: {"fwd", "bwd"} of {flops, bytes,
    n_ops, held}.  The loop visits n² block pairs, each the same ops on
    the same shapes, around per-block setup and the final concatenation;
    its backward adds, per pair, a gradient of the whole K and V (n
    blocks).  So each figure is a polynomial of degree 3 in n (from two
    blocks on: one block's slices are whole tensors): recorded at 2 to 5
    blocks, and checked at a 6th, on meta tensors, it is exact at every
    n.  Up to 6 blocks the loop is recorded as it is.  Memoized per
    key."""
    if n <= _FIT_POINTS[-1]:
        return _trace_flash(real, cfg, key, n)
    if key not in _FLASH_FITS:
        pts = [_trace_flash(real, cfg, key, m) for m in _FIT_POINTS]
        for ph in ("fwd", "bwd"):
            for f in _FIELDS:
                ys = [p[ph][f] for p in pts]
                if _cubic_at(ys[:4], _FIT_POINTS[4]) != ys[4]:
                    raise AssertionError(
                        f"flash_attention's {ph} {f} is not cubic in its "
                        f"block count at {key}: {ys} (the count's premise "
                        "fails)")
        _FLASH_FITS[key] = pts[:4]
    pts = _FLASH_FITS[key]
    return {ph: {f: _cubic_at([p[ph][f] for p in pts], n) for f in _FIELDS}
            for ph in ("fwd", "bwd")}


class _FlashCount(torch.autograd.Function):
    """``flash_attention`` counted: an output of its shape and dtype, the
    loop's cost recorded forward and backward (``flash_cost``), and what
    autograd keeps from the forward held as a meta tensor saved for the
    backward (so the live-bytes tracker sees it, and a checkpointed
    block's forward keeps nothing, as the loop's would)."""

    @staticmethod
    def forward(ctx, q, k, v, rec, real, cfg, key, n):
        with _suspended(rec):
            c = flash_cost(real, cfg, key, n)
        ctx.rec, ctx.cost, ctx.like = rec, c["bwd"], (q, k, v)
        fwd = c["fwd"]
        rec.cost.n_ops += fwd["n_ops"]
        _count_attention(rec, "forward", fwd)
        with _suspended(rec):
            out = q.new_empty(q.shape, dtype=cfg.adtype)
            if not _is_fake(q):
                out.zero_()
            held = torch.empty((fwd["held"],), dtype=torch.uint8,
                               device="meta")
        rec.track(out)
        if any(ctx.needs_input_grad[:3]):
            rec.track(held)
            ctx.save_for_backward(held)
        return out

    @staticmethod
    def backward(ctx, g):
        rec = ctx.rec
        ctx.saved_tensors                   # a checkpoint's recompute
        rec.cost.n_ops += ctx.cost["n_ops"]
        _count_attention(rec, "backward", ctx.cost)
        grads = []
        with _suspended(rec):
            for t, need in zip(ctx.like, ctx.needs_input_grad[:3]):
                grads.append(torch.zeros_like(t) if need else None)
        rec.track([t for t in grads if t is not None])
        return (*grads, None, None, None, None, None)


def _count_attention(rec, phase: str, c: dict):
    a = rec.cost.attention
    for f, v in ((f"{phase}_calls", 1), (f"{phase}_flops", c["flops"]),
                 (f"{phase}_bytes", c["bytes"])):
        a[f] = a.get(f, 0) + v
    rec.add(c["flops"], c["bytes"])


def _flash_shim(rec, real):
    """``layers.flash_attention`` while ``record`` runs: counted through
    ``_FlashCount`` for self-attention over equal query and key blocks
    in the contiguous (B, S, H, hd) layout ``layers._attention`` gives
    it; any other call is recorded op by op."""
    def flash_attention(cfg, q, k, v, *, causal=True, q_offset=0):
        b, s, h, hd = q.shape
        blk = min(cfg.q_block, s)
        if not (k.shape == v.shape == q.shape and q.dtype == k.dtype
                == v.dtype and cfg.q_block == cfg.kv_block
                and s % blk == 0
                and all(t.is_contiguous() for t in (q, k, v))):
            return real(cfg, q, k, v, causal=causal, q_offset=q_offset)
        grads = tuple(t.requires_grad and torch.is_grad_enabled()
                      for t in (q, k, v))
        key = (b, h, hd, q.dtype, blk, causal, q_offset, grads,
               cfg.sliding_window, cfg.adtype)
        return _FlashCount.apply(q, k, v, rec, real, cfg, key, s // blk)
    return flash_attention
