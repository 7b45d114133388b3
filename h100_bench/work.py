"""The yardstick's arithmetic: the chip's published peaks, the bytes and
FLOP of the weight switch, and the exact model's forward FLOP (each
family's count from its file, ``families/<family>.py``).

``switch_work`` is a frozen copy of the port's ``kernels/work.switch_work``
(the count its kernel checks use), kept here so that a change to the port
cannot move the benchmark's bound.  Nothing here imports the port.
"""
from __future__ import annotations

from h100_bench.families import family

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def switch_work(rows: int, d_in: int, d_h: int, d_out: int, *,
                n_classes: int, itemsize: int, w_itemsize: int | None = None,
                index_bytes: int = 0) -> tuple[int, int]:
    """(bytes, FLOP) of the weight switch over ``rows`` rows: each row
    read and its output written once, the class or row index vector
    (``index_bytes``), and the weights and biases of ``n_classes``
    classes; 2 · rows · (d_in·d_h + d_h·d_out) FLOP."""
    w_itemsize = itemsize if w_itemsize is None else w_itemsize
    w_bytes = n_classes * (d_in * d_h + d_h + d_h * d_out + d_out) \
        * w_itemsize
    n_bytes = rows * (d_in + d_out) * itemsize + index_bytes + w_bytes
    return n_bytes, 2 * rows * (d_in * d_h + d_h * d_out)


def switch_bound_s(dispatched, cfg: dict) -> float:
    """The least time, in seconds, for one call of the weight switch on a
    decode tick's logical dispatch: ``dispatched`` is the tick's rows per
    class (class 0, exact, first), the approximator classes' rows go
    through the switch at the configuration's widths, in bf16, with an
    int32 class per row.  The larger of bytes over the HBM bandwidth and
    FLOP over the bf16 peak; 0 when no row was approximated."""
    rows = [int(r) for r in list(dispatched)[1:]]
    used = sum(1 for r in rows if r > 0)
    total = sum(rows)
    if not total:
        return 0.0
    d, dh = cfg["d_model"], cfg["approx"]["d_hidden"]
    n_bytes, flops = switch_work(total, d, dh, d, n_classes=used,
                                 itemsize=2, index_bytes=4 * total)
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def mcma_sites(cfg: dict) -> int:
    """How many MCMA FFNs a token passes (its family's count)."""
    return family(cfg).mcma_sites(cfg)


def token_flops(cfg: dict, context: int, with_head: bool) -> int:
    """The exact model's forward FLOP for one token that attends over
    ``context`` positions (itself included): its family's layers, with
    the exact FFN at every MCMA site whatever the dispatch served, and the
    LM head when the token's logits are computed."""
    total = family(cfg).token_flops(cfg, context)
    if with_head:
        total += 2 * cfg["d_model"] * cfg["vocab"]
    return total


def span_flops(cfg: dict, start: int, n: int, with_head_last: bool) -> int:
    """FLOP of the positions ``start .. start + n - 1`` of one sequence,
    each attending over itself and every earlier position; the last one
    computes logits when ``with_head_last``.  A token's count is affine in
    its context, so the span's is n times the count at no context plus the
    slope times the sum of the contexts start+1 .. start+n."""
    if n <= 0:
        return 0
    base = token_flops(cfg, 0, False)
    slope = token_flops(cfg, 1, False) - base
    ctx = n * start + n * (n + 1) // 2
    return n * base + slope * ctx \
        + (2 * cfg["d_model"] * cfg["vocab"] if with_head_last else 0)
