"""Kernel host code and kernels of the PyTorch port against the JAX
reference: the same numpy inputs through ``repro.kernels`` (Pallas in
interpret mode) and ``repro_torch.kernels``; and, on a machine with a GPU
(marker ``cuda``), each CUDA kernel against its PyTorch version.

Plans, row indices and padded stacks must be exactly equal; kernel
outputs within the reference's kernel tolerances (3e-5 f32, 2e-2 bf16;
1e-5 for the sLSTM recurrence), and the fused path bitwise equal to the
unfused one inside the port.
"""
import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_dispatch as tfd
from repro_torch.kernels import mcma_mlp as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slstm_scan as tss
from repro_torch.kernels import switched_mlp as tsm
from repro_torch.kernels.sweeps import (CASES, MLP_SHAPES, SLSTM_SHAPES,
                                        mlp_inputs, slstm_inputs)
from repro_torch.kernels.sweeps import case_inputs as _inputs


@pytest.fixture(scope="module")
def J():
    """The JAX reference's kernel modules (the parity tests skip where JAX
    is not installed; the CUDA test below does not need it)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platform_name", "cpu")
    return types.SimpleNamespace(
        jnp=importlib.import_module("jax.numpy"),
        ops=importlib.import_module("repro.kernels.ops"),
        ref=importlib.import_module("repro.kernels.ref"),
        sk=importlib.import_module("repro.kernels.slstm_scan"),
        fd=importlib.import_module("repro.kernels.fused_dispatch"))


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=3e-5, atol=3e-5)


def _torch(a, dtype="float32", device="cpu"):
    t = torch.from_numpy(a).to(device)
    return t.to(getattr(torch, dtype)) if t.is_floating_point() else t


def _jax(J, a, dtype="float32"):
    j = J.jnp.asarray(a)
    return j.astype(getattr(J.jnp, dtype)) if a.dtype == np.float32 else j


@pytest.mark.parametrize("case", sorted(CASES))
def test_class_sort_plan_and_row_index_match_jax(J, case):
    _, cls, w, block = _inputs(case)
    n, t = w[0].shape[0], cls.shape[0]
    jp = J.ops.class_sort_plan(_jax(J, cls), n, block)
    tp = tops.class_sort_plan(_torch(cls), n, block)
    assert jp[4] == tp[4]
    for name, a, b in zip(("order", "pos", "tile_cls", "padded_sizes"),
                          jp[:4], tp[:4]):
        assert b.dtype == torch.int32, (name, b.dtype)
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    jrows = J.fd.fused_row_index(jp[0], jp[1], t, jp[4])
    trows = tfd.fused_row_index(tp[0], tp[1], t, tp[4])
    assert trows.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jrows), trows.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepad_and_resident_gather_match_jax(J, dtype):
    _, _, w, _ = _inputs("mcma_default")
    jw = J.ops.prepad_switched_weights(*[_jax(J, a, dtype) for a in w])
    tw = tops.prepad_switched_weights(*[_torch(a, dtype) for a in w])
    # pinned residency cases: in range, out of range both ways, duplicates
    res = np.asarray([2, -1, 3, 0, 0], np.int32)
    jr = J.ops.gather_resident_stacks(*jw, _jax(J, res))
    tr = tops.gather_resident_stacks(*tw, _torch(res))
    for a, b in zip((*jw, *jr), (*tw, *tr)):
        assert b.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32),
                                      b.float().numpy())


# every sweep in float32, the mixed-shape ones in bfloat16 as well (the
# reference runs its edge cases in float32 only)
DTYPE_CASES = [(c, "float32") for c in sorted(CASES)] + [
    (c, "bfloat16") for c in sorted(CASES) if CASES[c][-1] == "random"]


@pytest.mark.parametrize("case,dtype", DTYPE_CASES)
def test_switched_apply_plain_matches_jax_kernels(J, case, dtype):
    x, cls, w, block = _inputs(case)
    jargs = [_jax(J, a, dtype) for a in (x, cls, *w)]
    targs = [_torch(a, dtype) for a in (x, cls, *w)]
    want = np.asarray(J.ops.switched_apply(*jargs, block_t=block,
                                           interpret=True), np.float32)
    want_f = np.asarray(J.ops.switched_apply_fused(
        *jargs, block_t=block, interpret=True), np.float32)
    got = tops.switched_apply(*targs, block_t=block)
    got_f = tops.switched_apply_fused(*targs, block_t=block)
    assert got.dtype == got_f.dtype == targs[0].dtype
    assert got.shape == got_f.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))
    np.testing.assert_allclose(got_f.float().numpy(), want_f, **_tol(dtype))
    assert torch.equal(got, got_f), "fused != unfused inside the port"
    np.testing.assert_allclose(
        got.float().numpy(),
        tref.switched_mlp_ref(*targs).float().numpy(), **_tol(dtype))
    if case == "all_nc":
        assert not got.any()


def test_wrappers_refuse_other_devices():
    x = torch.zeros((128, 128), device="meta")
    tile_cls = torch.zeros((1,), dtype=torch.int32, device="meta")
    w = [torch.zeros(s, device="meta") for s in
         ((1, 128, 128), (1, 1, 128), (1, 128, 128), (1, 1, 128))]
    with pytest.raises(ValueError, match="no kernel"):
        tsm.switched_mlp(x, tile_cls, *w, block_t=128)
    with pytest.raises(ValueError, match="no kernel"):
        tfd.switched_mlp_fused(x, torch.zeros((128,), dtype=torch.int32,
                                              device="meta"),
                               tile_cls, *w, block_t=128)
    with pytest.raises(ValueError, match="no kernel"):
        tmm.mlp_forward(x, w[0][0], w[1][0], w[2][0], w[3][0], block_t=128)
    st = torch.zeros((2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tss.slstm_scan(torch.zeros((4, 2, 2, 32), device="meta"),
                       torch.zeros((2, 8, 32), device="meta"), st, st, st, st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d_in,d_h,d_out", MLP_SHAPES)
def test_mlp_apply_matches_jax_kernel(J, dtype, t, d_in, d_h, d_out):
    """The port rounds ``h`` to x's dtype as the reference kernel does
    (mcma_mlp.py:32), so it is held to that kernel; ``ref.mlp_forward_ref``
    does not round ``h`` and agrees within the bf16 tolerance only."""
    a = mlp_inputs(t, d_in, d_h, d_out)
    want = np.asarray(J.ops.mlp_apply(*[_jax(J, v, dtype) for v in a],
                                      block_t=128, interpret=True),
                      np.float32)
    targs = [_torch(v, dtype) for v in a]
    got = tops.mlp_apply(*targs, block_t=128)
    assert got.shape == (t, d_out) and got.dtype == targs[0].dtype
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               tref.mlp_forward_ref(*targs).float().numpy(),
                               **_tol(dtype))
    np.testing.assert_allclose(
        tref.mlp_forward_ref(*targs).float().numpy(),
        np.asarray(J.ref.mlp_forward_ref(*[_jax(J, v, dtype) for v in a]),
                   np.float32), **_tol(dtype))


@pytest.mark.parametrize("s,b,h,hd", SLSTM_SHAPES)
def test_slstm_scan_plain_matches_jax_kernel_and_ref(J, s, b, h, hd):
    a = slstm_inputs(s, b, h, hd)
    jys, jfin = J.sk.slstm_scan(*map(J.jnp.asarray, a), interpret=True)
    rys, rfin = J.ref.slstm_scan_ref(*map(J.jnp.asarray, a))
    n0 = tss.slstm_scan.launches
    ys, fin = tss.slstm_scan(*map(torch.from_numpy, a))
    assert tss.slstm_scan.launches == n0      # CPU tensors: the plain version
    tys, tfin = tref.slstm_scan_ref(*map(torch.from_numpy, a))
    tol = dict(rtol=1e-5, atol=1e-5)
    for got in ((ys, fin), (tys, tfin)):
        for want in ((jys, jfin), (rys, rfin)):
            for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
                assert g.dtype == torch.float32 and g.shape == w.shape
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_slstm_scan_plain_rounds_h_like_the_jax_kernel(J):
    """bf16 ``wh``: the plain version rounds ``h`` to bf16 and sums the
    product in f32, as the reference kernel does (its ``ref`` does not
    round ``h``)."""
    xg, wh, *st = slstm_inputs(32, 4, 4, 16)
    jwh = J.jnp.asarray(wh).astype(J.jnp.bfloat16)
    jys, jfin = J.sk.slstm_scan(J.jnp.asarray(xg), jwh,
                                *map(J.jnp.asarray, st), interpret=True)
    ys, fin = tss.slstm_scan(torch.from_numpy(xg),
                             torch.from_numpy(wh).to(torch.bfloat16),
                             *map(torch.from_numpy, st))
    for g, w in zip((ys, *fin), (jys, *jfin)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", DTYPE_CASES)
def test_cuda_kernels_match_plain(case, dtype):
    _cuda()
    x, cls, w, block = _inputs(case)
    xt, ct = _torch(x, dtype, "cuda"), _torch(cls, device="cuda")
    xp, rows, tile_cls, weights, order, pos = tops.kernel_operands(
        xt, ct, *[_torch(a, dtype, "cuda") for a in w], block_t=block)
    n0 = tsm.switched_mlp.launches
    y = tsm.switched_mlp(xp, tile_cls, *weights, block_t=block)
    yf = tfd.switched_mlp_fused(xt, rows, tile_cls, *weights, block_t=block)
    torch.cuda.synchronize()
    assert tsm.switched_mlp.launches == n0 + 1
    want = tsm.switched_mlp_plain(xp, tile_cls, *weights, block_t=block)
    torch.testing.assert_close(y.float(), want.float(), **_tol(dtype))
    assert torch.equal(yf[:x.shape[0]], y[pos.long()][torch.argsort(
        order.long())]), "fused != unfused"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d_in,d_h,d_out", MLP_SHAPES)
def test_cuda_mlp_forward_matches_plain(dtype, t, d_in, d_h, d_out):
    _cuda()
    a = [_torch(v, dtype, "cuda") for v in mlp_inputs(t, d_in, d_h, d_out)]
    n0 = tmm.mlp_forward.launches
    got = tops.mlp_apply(*a, block_t=128)
    torch.cuda.synchronize()
    assert tmm.mlp_forward.launches == n0 + 1
    cpu = tops.mlp_apply(*[v.cpu() for v in a], block_t=128)
    torch.testing.assert_close(got.float().cpu(), cpu.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,b,h,hd", SLSTM_SHAPES)
def test_cuda_slstm_scan_matches_plain(wdtype, s, b, h, hd):
    _cuda()
    xg, wh, *st = [torch.from_numpy(v).cuda()
                   for v in slstm_inputs(s, b, h, hd)]
    wh = wh.to(getattr(torch, wdtype))
    n0 = tss.slstm_scan.launches
    ys, fin = tss.slstm_scan(xg, wh, *st)
    torch.cuda.synchronize()
    assert tss.slstm_scan.launches == n0 + 1
    pys, pfin = tss.slstm_scan_plain(xg, wh, *st)
    for g, w in zip((ys, *fin), (pys, *pfin)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _config_case(name):
    """(t, n, d_in, d_h, d_out, block) of a served model's dispatch: 8
    rows (the decode batch) over its approximators and the pseudo-class."""
    from repro_torch.configs.registry import get_config, smoke_config
    cfg = get_config("internlm2-1.8b")
    if name.endswith("smoke"):
        cfg = smoke_config(cfg)
    a = cfg.approx
    return (8, a.n_approx + 1, cfg.d_model, a.d_hidden, cfg.d_model,
            a.block_t)


SERVED = sorted(CASES) + ["internlm2-1.8b", "internlm2-1.8b-smoke"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SERVED)
def test_cuda_limits_admit_every_served_shape(case, dtype):
    """The tile routine's limits (check_cuda_args) take the operands that
    ops builds for every sweep and for internlm2-1.8b's decode dispatch at
    full width and in its smoke config: a limit that shuts out a served
    shape fails here, not on the card."""
    if case in CASES:
        x, cls, w, block = _inputs(case)
    else:
        t, n, d_in, d_h, d_out, block = _config_case(case)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(t, d_in)).astype(np.float32)
        cls = rng.integers(0, n, t).astype(np.int32)
        w = [rng.normal(size=s).astype(np.float32) for s in (
            (n, d_in, d_h), (n, d_h), (n, d_h, d_out), (n, d_out))]
    xt = _torch(x, dtype)
    xp, rows, tile_cls, weights, _, _ = tops.kernel_operands(
        xt, _torch(cls), *[_torch(a, dtype) for a in w], block_t=block)
    sfx = {"float32": "f32", "bfloat16": "bf16"}[dtype]
    assert tsm.check_cuda_args(xp, (tile_cls,), weights, block_t=block,
                               name="switched_mlp") == sfx
    assert tsm.check_cuda_args(xt, (rows, tile_cls), weights, block_t=block,
                               name="switched_mlp_fused") == sfx


@pytest.mark.parametrize("shape", MLP_SHAPES + [(2048, 2048, 256, 2048)])
def test_cuda_limits_admit_mlp_apply_shapes(shape):
    """The same for ``ops.mlp_apply``'s operands: the reference's shapes
    and the full-width ApproxFFN shape chip_smoke.py times."""
    a = [torch.zeros(s) for s in ((shape[0], shape[1]), shape[1:3],
                                  (shape[2],), shape[2:4], (shape[3],))]
    block = 256 if shape[0] == 2048 else 128
    xo, w1, b1, w2, b2 = tops.mlp_operands(*a, block_t=block)
    assert tsm.check_cuda_args(xo, (), tmm._one_class(w1, b1, w2, b2),
                               block_t=block, name="mlp_forward") == "f32"


def test_cuda_limits_refuse_what_the_routine_cannot_take():
    x = torch.zeros((64, 128))
    tile_cls = torch.zeros((1,), dtype=torch.int32)

    def stacks(d_in, d_h, d_out):
        return [torch.zeros(s) for s in ((1, d_in, d_h), (1, 1, d_h),
                                         (1, d_h, d_out), (1, 1, d_out))]
    for dims, block, match in (((128, 64, 128), 64, "multiples of 128"),
                               ((128, 640, 128), 64, "shared memory"),
                               ((128, 128, 128), 24, "block_t")):
        with pytest.raises(ValueError, match=match):
            tsm.check_cuda_args(x, (tile_cls,), stacks(*dims), block_t=block,
                                name="switched_mlp")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_at_decode_width(dtype):
    """Both kernels at internlm2-1.8b's full-width decode dispatch (8 rows,
    n 3 + the zero pseudo-class, d 2048, d_h 256, block_t 128, t_pad 640)
    within tolerance of their plain versions, fused bitwise equal to
    switched on every real row."""
    _cuda()
    t, n, d_in, d_h, d_out, block = _config_case("internlm2-1.8b")
    rng = np.random.default_rng(7)
    x = _torch(rng.normal(size=(t, d_in)).astype(np.float32), dtype, "cuda")
    w = [_torch((rng.normal(size=s) * sc).astype(np.float32), dtype, "cuda")
         for s, sc in (((n, d_in, d_h), d_in ** -0.5), ((n, d_h), 0.1),
                       ((n, d_h, d_out), d_h ** -0.5), ((n, d_out), 0.1))]
    for a in w:
        a[-1] = 0
    cls = _torch(rng.integers(0, n, t).astype(np.int32), device="cuda")
    xp, rows, tile_cls, weights, order, pos = tops.kernel_operands(
        x, cls, *w, block_t=block)
    assert xp.shape[0] == 640
    y = tsm.switched_mlp(xp, tile_cls, *weights, block_t=block)
    yf = tfd.switched_mlp_fused(x, rows, tile_cls, *weights, block_t=block)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y.float(), tsm.switched_mlp_plain(xp, tile_cls, *weights,
                                          block_t=block).float(),
        **_tol(dtype))
    torch.testing.assert_close(
        yf[:t].float(), tfd.switched_mlp_fused_plain(
            x, rows, tile_cls, *weights, block_t=block)[:t].float(),
        **_tol(dtype))
    assert torch.equal(yf[:t], y[pos.long()][torch.argsort(order.long())])


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_operands_reproduce_switched_apply(case):
    """The operands chip_smoke.py and the CUDA test hand the kernels are
    those of ops.switched_apply(_fused): through either kernel they give
    its result bitwise."""
    x, cls, w, block = _inputs(case)
    targs = [_torch(a) for a in (x, cls, *w)]
    xp, rows, tile_cls, weights, order, pos = tops.kernel_operands(
        *targs, block_t=block)
    assert rows.dtype == tile_cls.dtype == torch.int32
    t, d_out = x.shape[0], w[2].shape[2]
    y = tsm.switched_mlp(xp, tile_cls, *weights, block_t=block)
    unsorted = y[pos.long()][torch.argsort(order.long())]
    yf = tfd.switched_mlp_fused(targs[0], rows, tile_cls, *weights,
                                block_t=block)
    assert torch.equal(yf[:t], unsorted)
    assert torch.equal(unsorted[:, :d_out],
                       tops.switched_apply(*targs, block_t=block))


# --- the sLSTM kernel's planner (how one call is split over the card) ---

H100_SMS, H100_SMEM = 132, 232448    # SMs; shared memory a CTA may opt in to


def _xlstm_dims(name):
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models.xlstm import slstm_dims
    cfg = get_config("xlstm-1.3b")
    if name.endswith("smoke"):
        cfg = smoke_config(cfg)
    return slstm_dims(cfg)[1:]


SLSTM_SERVED = [(b, *_xlstm_dims(name)) for name in ("xlstm-1.3b",
                                                     "xlstm-1.3b-smoke")
                for b in (1, 2, 8, 64, 256)] + [(b, h, hd)
                                       for _, b, h, hd in SLSTM_SHAPES]


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hd", SLSTM_SERVED)
def test_slstm_plan_admits_every_served_shape(b, h, hd, wdtype):
    """The planner places xlstm-1.3b at full width (prefill and decode
    share (B, H, hd)) and in its smoke config, at any served batch (up
    to 256), and every sweep, on an H100: one CTA per SM at most, within
    the shared-memory limit, every unit of every head owned by one CTA,
    every batch row in one of the chunks of a step."""
    p = tss.plan(b, h, hd, getattr(torch, wdtype), n_sm=H100_SMS,
                 smem_limit=H100_SMEM)
    assert p.grid == h * p.ctas_per_head <= H100_SMS
    assert p.units % 8 == 0 and p.units * p.ctas_per_head >= hd
    assert p.units * (p.ctas_per_head - 1) < hd
    assert p.chunks * tss.ROWS >= b > (p.chunks - 1) * tss.ROWS
    assert p.smem_bytes == tss.smem_bytes(getattr(torch, wdtype), hd,
                                          p.units) <= H100_SMEM
    if (h, hd) == (4, 512):
        # the design: 32 CTAs of 16 units per head, one per SM, 128 in all
        assert (p.units, p.ctas_per_head, p.grid) == (16, 32, 128)


def test_slstm_plan_splits_the_ragged_sweep_raggedly():
    """(5, 3, 4, 44): the last CTA of each head owns fewer units than the
    others, and the mma's K (hd rounded up to 16) is ragged."""
    p = tss.plan(3, 4, 44, torch.bfloat16, n_sm=H100_SMS,
                 smem_limit=H100_SMEM)
    assert 44 % p.units != 0 and 44 % 16 != 0


@pytest.mark.parametrize("b,h,hd,wdtype,match", [
    (8, 4, 4096, torch.bfloat16, "SMs"),          # too many CTAs
    (8, 1, 4096, torch.bfloat16, "shared memory"),  # slice too large
    (512, 2, 1024, torch.float32, "shared memory"),  # slice too large
    (8, 8, 4096, torch.float32, "SMs"),
])
def test_slstm_plan_refuses_what_cannot_be_placed(b, h, hd, wdtype, match):
    with pytest.raises(ValueError, match=match):
        tss.plan(b, h, hd, wdtype, n_sm=H100_SMS, smem_limit=H100_SMEM)


def test_slstm_scan_trainable_grads_match_jax(J):
    """The autograd Function (kernel forward, reference-recompute backward)
    against the reference's custom_vjp on the same numpy inputs
    (tests/test_kernels.py:249-270, same tolerance: rtol 1e-4, atol
    1e-5), and against autograd through the torch reference scan."""
    import jax
    xg, wh, z, _, _, m0 = slstm_inputs(12, 2, 2, 8)

    def loss_jax(xg, wh):
        ys, _ = J.sk.slstm_scan_trainable(xg, wh, z, z, z, m0, True)
        return J.jnp.sum(ys ** 2)

    want = jax.grad(loss_jax, argnums=(0, 1))(J.jnp.asarray(xg),
                                              J.jnp.asarray(wh))
    txg, twh = (torch.from_numpy(a).requires_grad_() for a in (xg, wh))
    st = [torch.from_numpy(a) for a in (z, z, z, m0)]
    n0 = tss.slstm_scan.launches
    ys, fin = tss.slstm_scan_trainable(txg, twh, *st)
    assert tss.slstm_scan.launches == n0      # CPU tensors: the plain version
    got = torch.autograd.grad((ys ** 2).sum(), (txg, twh))
    ref_ys, _ = tref.slstm_scan_ref(txg, twh, *st)
    ref_g = torch.autograd.grad((ref_ys ** 2).sum(), (txg, twh))
    plain = tss.slstm_scan_plain(txg.detach(), twh.detach(), *st)
    for g, w, r in zip(got, want, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-5)
    for g, w in zip((ys, *fin), (plain[0], *plain[1])):
        assert torch.equal(g.detach(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_cuda_slstm_scan_matches_plain_at_full_width(wdtype):
    """xlstm-1.3b's prefill shape (256, 8, 4, 512) through one cooperative
    launch, within chip_smoke.py's full-width tolerance of the plain
    version (1e-4 with f32 weights, 2e-2 with bf16), all finite, and the
    same bits from run to run (partial sums added in a fixed order)."""
    _cuda()
    shape = (256, 8, 4, 512)
    xg, wh, *st = [torch.from_numpy(v).cuda()
                   for v in slstm_inputs(*shape, wh_scale=512 ** -0.5)]
    wh = wh.to(getattr(torch, wdtype))
    ys, fin = tss.slstm_scan(xg, wh, *st)
    again, _ = tss.slstm_scan(xg, wh, *st)
    pys, pfin = tss.slstm_scan_plain(xg, wh, *st)
    torch.cuda.synchronize()
    tol = 1e-4 if wdtype == "float32" else 2e-2
    for g, w in zip((ys, *fin), (pys, *pfin)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    assert torch.equal(ys, again)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,b", [(16, 64), (4, 256)])
def test_cuda_slstm_scan_matches_plain_at_large_batch(s, b, wdtype):
    """xlstm-1.3b's width at batches that DecodeServer's slot table may
    hold (--batch) beyond the 8 of the smoke run: 8 and 32 chunks of
    batch rows a step, within the full-width tolerance of the plain
    version."""
    _cuda()
    xg, wh, *st = [torch.from_numpy(v).cuda()
                   for v in slstm_inputs(s, b, 4, 512, wh_scale=512 ** -0.5)]
    wh = wh.to(getattr(torch, wdtype))
    ys, fin = tss.slstm_scan(xg, wh, *st)
    pys, pfin = tss.slstm_scan_plain(xg, wh, *st)
    torch.cuda.synchronize()
    tol = 1e-4 if wdtype == "float32" else 2e-2
    for g, w in zip((ys, *fin), (pys, *pfin)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hd", SLSTM_SERVED)
def test_cuda_slstm_plan_matches_the_kernels_layout(b, h, hd, wdtype):
    """The planner's mirror of the kernel's shared-memory layout
    (``smem_bytes``) equals the dynamic shared memory the .cu computes,
    and the planned grid fits the card at the occupancy the driver
    reports, at every served shape."""
    _cuda()
    r = tss.resources(b, h, hd, getattr(torch, wdtype))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert r["dynamic_smem"] == r["plan_smem"]
    assert r["grid"] <= r["ctas_per_sm"] * n_sm


@pytest.mark.cuda
def test_cuda_slstm_scan_trainable_grad_through_the_kernel():
    """Gradients of the autograd Function on the card (the forward through
    the kernel) equal autograd through the reference scan on the card."""
    _cuda()
    xg, wh, *st = [torch.from_numpy(v).cuda()
                   for v in slstm_inputs(12, 2, 2, 8)]
    leaves = [xg.clone().requires_grad_(), wh.clone().requires_grad_()]
    n0 = tss.slstm_scan.launches
    ys, _ = tss.slstm_scan_trainable(*leaves, *st)
    got = torch.autograd.grad((ys ** 2).sum(), leaves)
    assert tss.slstm_scan.launches == n0 + 1
    ref_ys, _ = tref.slstm_scan_ref(*leaves, *st)
    want = torch.autograd.grad((ref_ys ** 2).sum(), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
