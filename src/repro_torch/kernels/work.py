"""The work of each kernel's function: the bytes it must move (each input
read once, each output written once) and the FLOP it must do, at the
rows and widths of its operands.  One count, read by ``chip_smoke.py``
for a kernel's bound and by ``launch/hlo_cost.py`` for a kernel op of a
recorded step (which does not enter the wrapper: the wrapper's PyTorch
twin pads and gathers per tile, which is not the kernel's work).
"""
from __future__ import annotations


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


def slstm_work(s: int, b: int, h: int, hd: int, *,
               wh_itemsize: int) -> tuple[int, int]:
    """(bytes, FLOP) of the sLSTM scan: the (S, B, H, 4·hd) f32 gates in,
    the (S, B, H, hd) outputs and the four (B, H, hd) states in and out,
    ``wh`` (H, hd, 4·hd) once; the recurrent product's 2·S·B·H·hd·4·hd
    FLOP."""
    n_bytes = (s * b * h * 4 * hd + s * b * h * hd + 8 * b * h * hd) * 4 \
        + h * hd * 4 * hd * wh_itemsize
    return n_bytes, 2 * s * b * h * hd * 4 * hd


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def wrapper_work(name: str, args, kwargs) -> tuple[int, int]:
    """(bytes, FLOP) of one call of the kernel wrapper ``name`` (an
    attribute of ``analysis/opcount.KERNEL_WRAPPERS``) on its arguments.
    The weight switches count every class their stack holds (which
    classes a call reads depends on the values), over the rows they map:
    ``switched_mlp`` the class-sorted padded rows it is given,
    ``switched_mlp_fused`` the rows of x, gathered and stored through
    ``rows``."""
    if name == "switched_mlp":
        x, tile_cls, w1, _, w2, _ = args[:6]
        return switch_work(x.shape[0], x.shape[1], w1.shape[2], w2.shape[2],
                           n_classes=w1.shape[0], itemsize=x.element_size(),
                           w_itemsize=w1.element_size(),
                           index_bytes=_nbytes(tile_cls))
    if name == "switched_mlp_fused":
        x, rows, tile_cls, w1, _, w2, _ = args[:7]
        return switch_work(x.shape[0], x.shape[1], w1.shape[2], w2.shape[2],
                           n_classes=w1.shape[0], itemsize=x.element_size(),
                           w_itemsize=w1.element_size(),
                           index_bytes=_nbytes(rows) + _nbytes(tile_cls))
    if name == "mlp_forward":
        x, w1, _, w2, _ = args[:5]
        return switch_work(x.shape[0], x.shape[1], w1.shape[1], w2.shape[1],
                           n_classes=1, itemsize=x.element_size(),
                           w_itemsize=w1.element_size())
    if name == "slstm_scan":
        xg, wh = args[:2]
        s, b, h, hd4 = xg.shape
        assert hd4 % 4 == 0, xg.shape        # the 4 gates of each unit
        return slstm_work(s, b, h, hd4 // 4, wh_itemsize=wh.element_size())
    raise KeyError(f"no work count for kernel wrapper {name!r}")
