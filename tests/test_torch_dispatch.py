"""The PyTorch port's dispatch engine against the JAX reference.

Both packages get the SAME router logits (never logits computed on each
side, whose ulp differences can flip an argmax), so every discrete output
— the plan and the invoke stats — must be exactly equal and int32, and
the dispatched rows within the kernel tolerance (3e-5, float32).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.runtime import dispatch as TD  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

T, N, D, DH, BLOCK = 24, 3, 32, 16, 16
CAPS = {"uniform": (8, 5), "asymmetric": (6, (3, 7, 2))}


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    logits = rng.normal(size=(T, N + 1)).astype(np.float32)
    w = [(rng.normal(size=s) * 0.3).astype(np.float32) for s in
         ((N, D, DH), (N, DH), (N, DH, D), (N, D))]
    w_exact = (rng.normal(size=(D, D)) * 0.2).astype(np.float32)
    mask = rng.random(T) < 0.7
    tier = rng.integers(0, 3, T).astype(np.int32)
    return x, logits, w, w_exact, mask, tier


def _assert_same(jv, tv, name):
    jv = np.asarray(jv)
    assert tv.dtype == to_torch(jv).dtype, (name, tv.dtype, jv.dtype)
    np.testing.assert_array_equal(jv, tv.numpy(), err_msg=name)


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_fused"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("caps", sorted(CAPS))
def test_plan_matches_jax(backend, masked, caps):
    x, logits, _, _, mask, _ = _setup()
    ec, ic = CAPS[caps]
    m = (jnp.asarray(mask), to_torch(mask)) if masked else (None, None)
    jp = JD.make_dispatch_plan(jnp.asarray(logits), m[0], exact_cap=ec,
                               invoke_cap=ic, backend=backend, block_t=BLOCK)
    tp = TD.make_dispatch_plan(to_torch(logits), m[1], exact_cap=ec,
                               invoke_cap=ic, backend=backend, block_t=BLOCK)
    for f in JD._PLAN_DATA:
        _assert_same(getattr(jp, f), getattr(tp, f), f)
    for f in JD._PLAN_META:
        assert getattr(jp, f) == getattr(tp, f), f
    assert tp.class_caps == jp.class_caps


@pytest.mark.parametrize("variant", ["tier", "residency"])
def test_plan_tiers_and_residency_match_jax(variant):
    _, logits, _, _, mask, tier = _setup(1)
    kw_j, kw_t = {}, {}
    if variant == "tier":
        margins = np.asarray([0.5, 0.0, -0.5], np.float32)
        kw_j = dict(tier=jnp.asarray(tier), tier_margins=jnp.asarray(margins))
        kw_t = dict(tier=to_torch(tier), tier_margins=to_torch(margins))
    else:     # a 3-slot residency map over a 5-class library
        lib_logits = np.random.default_rng(2).normal(size=(T, 6)) \
            .astype(np.float32)
        logits = lib_logits
        res = np.asarray([4, 0, 2], np.int32)
        kw_j, kw_t = dict(residency=jnp.asarray(res)), \
            dict(residency=to_torch(res))
    jp = JD.make_dispatch_plan(jnp.asarray(logits), jnp.asarray(mask),
                               exact_cap=8, invoke_cap=4, backend="pallas",
                               block_t=BLOCK, **kw_j)
    tp = TD.make_dispatch_plan(to_torch(logits), to_torch(mask),
                               exact_cap=8, invoke_cap=4, backend="pallas",
                               block_t=BLOCK, **kw_t)
    for f in JD._PLAN_DATA:
        _assert_same(getattr(jp, f), getattr(tp, f), f)
    js, ts = JD.plan_invoke_stats(jp), TD.plan_invoke_stats(tp)
    for f in js:
        _assert_same(js[f], ts[f], f)


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_fused"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("caps", sorted(CAPS))
def test_mcma_dispatch_matches_jax(backend, masked, caps):
    x, logits, w, w_exact, mask, _ = _setup()
    ec, ic = CAPS[caps]
    jw = jops.prepad_switched_weights(*[jnp.asarray(a) for a in w])
    tw = tops.prepad_switched_weights(*[to_torch(a) for a in w])
    je, te = jnp.asarray(w_exact), to_torch(w_exact)
    jy, js = JD.mcma_dispatch(
        jnp.asarray(x), jnp.asarray(logits), lambda xb: jnp.tanh(xb @ je),
        *jw, exact_cap=ec, invoke_cap=ic, backend=backend, block_t=BLOCK,
        interpret=True, row_mask=jnp.asarray(mask) if masked else None,
        weights_prepadded=True)
    ty, ts = TD.mcma_dispatch(
        to_torch(x), to_torch(logits), lambda xb: torch.tanh(xb @ te),
        *tw, exact_cap=ec, invoke_cap=ic, backend=backend, block_t=BLOCK,
        row_mask=to_torch(mask) if masked else None, weights_prepadded=True)
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=3e-5,
                               atol=3e-5)
    assert set(ts.keys()) == set(js.keys())
    for f in js:
        _assert_same(js[f], ts[f], f)


def test_unpadded_stacks_and_backends_agree_inside_the_port():
    """The three backends agree on the same plan (kernels bitwise with
    each other), with prepadded and with logical (n, d, d_h) stacks."""
    x, logits, w, w_exact, mask, _ = _setup(3)
    te = to_torch(w_exact)
    outs = {}
    for backend in TD.DISPATCH_BACKENDS:
        for pre in (False, True):
            stacks = tops.prepad_switched_weights(*[to_torch(a) for a in w]) \
                if pre else [to_torch(a) for a in w]
            outs[backend, pre], _ = TD.mcma_dispatch(
                to_torch(x), to_torch(logits), lambda xb: xb @ te, *stacks,
                exact_cap=8, invoke_cap=(3, 7, 2), backend=backend,
                block_t=BLOCK, row_mask=to_torch(mask),
                weights_prepadded=pre)
    for key, y in outs.items():
        torch.testing.assert_close(y, outs["xla", False], rtol=3e-5,
                                   atol=3e-5, msg=str(key))
    assert torch.equal(outs["pallas", True], outs["pallas_fused", True])


def test_scatter_gather_pinned_indices():
    rows = torch.arange(12, dtype=torch.float32).reshape(6, 2) + 1
    slot = torch.tensor([0, 2, 9, -1, 2, 1], dtype=torch.int32)
    keep = torch.tensor([True, True, True, True, False, True])
    buf = TD.scatter_rows(rows, slot, keep, 3)
    jbuf = JD.scatter_rows(jnp.asarray(rows.numpy()), jnp.asarray(slot.numpy()),
                           jnp.asarray(keep.numpy()), 3)
    np.testing.assert_array_equal(np.asarray(jbuf), buf.numpy())
    got = TD.gather_rows(buf, slot, keep)
    want = JD.gather_rows(jbuf, jnp.asarray(slot.numpy()),
                          jnp.asarray(keep.numpy()))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    cls = np.asarray([2, 0, 2, 1, 0, 2, 2], np.int32)
    ranks = TD.class_sort_ranks(to_torch(cls), 3)
    jranks = JD.class_sort_ranks(jnp.asarray(cls), 3)
    for a, b in zip(jranks, ranks):
        _assert_same(a, b, "class_sort_ranks")
    for offset in (0, 1):
        keep, slot = TD.capacity_slots(ranks[1], ranks[2], 2, n_local=2,
                                       offset=offset)
        jkeep, jslot = JD.capacity_slots(jranks[1], jranks[2], 2, n_local=2,
                                         offset=offset)
        _assert_same(jkeep, keep, "keep")
        _assert_same(jslot, slot, "slot")
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    mask = cls == 2
    got = TD.capacity_path(to_torch(x), to_torch(mask), 3, lambda b: b * 2)
    want = JD.capacity_path(jnp.asarray(x), jnp.asarray(mask), 3,
                            lambda b: b * 2)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
