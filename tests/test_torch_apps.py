"""The port's apps registry and target functions against the JAX
reference: each function of ``function_zoo()`` on the same numpy inputs
within rtol = atol = 3e-5 (jmeint's one-hot exactly), the ``App`` fields
and ``MLPSpec`` equal, and the port's generators and ``make_dataset``
well-formed (their streams cannot equal ``jax.random``'s)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.apps import functions as JF  # noqa: E402
from repro.apps import registry as JR  # noqa: E402
from repro.core.mlp import MLPSpec as JSpec  # noqa: E402
from repro_torch.apps import functions as TF  # noqa: E402
from repro_torch.apps import registry as TR  # noqa: E402
from repro_torch.core.mlp import MLPSpec  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=3e-5, atol=3e-5)
NAMES = [a.name for a in JR.function_zoo()]


def _inputs(app, n=512, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(app.in_lo), np.asarray(app.in_hi)
    return (rng.random((n, app.n_in)) * (hi - lo) + lo).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_function_matches_jax(name):
    japp, tapp = JR.get_app(name), TR.get_app(name)
    x = _inputs(japp)
    want = np.asarray(japp.fn(jnp.asarray(x)))
    got = tapp.fn(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if japp.err_kind == "class":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tapp.normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(japp.normalize(jnp.asarray(x))),
                               **TOL)


def test_helpers_match_jax():
    z = np.linspace(-9.0, 9.0, 241).astype(np.float32)
    for jf, tf in ((JF._j0, TF._j0), (JF._j1, TF._j1),
                   (JF._ncdf, TF._ncdf)):
        np.testing.assert_allclose(tf(torch.from_numpy(z)).numpy(),
                                   np.asarray(jf(jnp.asarray(z))), **TOL)
    np.testing.assert_allclose(TF._dct_matrix().numpy(),
                               np.asarray(JF._dct_matrix()), **TOL)
    rng = np.random.default_rng(1)
    tri = rng.normal(size=(64, 3, 3)).astype(np.float32)
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    for g, w in zip(TF._project(torch.from_numpy(tri),
                                torch.from_numpy(axis)),
                    JF._project(jnp.asarray(tri), jnp.asarray(axis))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    tri2 = tri[::-1].copy()
    np.testing.assert_array_equal(
        TF._sat_separated(torch.from_numpy(tri), torch.from_numpy(tri2),
                          torch.from_numpy(axis)).numpy(),
        np.asarray(JF._sat_separated(jnp.asarray(tri), jnp.asarray(tri2),
                                     jnp.asarray(axis))))


def test_registry_fields_and_specs_match_jax():
    assert [a.name for a in TR.function_zoo()] == NAMES
    assert [a.name for a in TR.function_zoo(domain="Signal Processing")] \
        == [a.name for a in JR.function_zoo(domain="Signal Processing")]
    assert [a.name for a in TR.function_zoo(names=("sobel", "fft"))] == \
        ["sobel", "fft"]
    skip = {"fn", "gen"}
    for name in NAMES:
        j, t = JR.get_app(name), TR.get_app(name)
        for f in dataclasses.fields(j):
            if f.name not in skip:
                assert getattr(t, f.name) == getattr(j, f.name), \
                    (name, f.name)
        assert dataclasses.asdict(t.approx_spec) == \
            dataclasses.asdict(j.approx_spec)
        assert dataclasses.asdict(t.cls_spec(4)) == \
            dataclasses.asdict(j.cls_spec(4))
    for topo in ("6->8->1", "18 -> 32 -> 16 -> 2", "1->2->2->2"):
        t, j = MLPSpec.parse(topo), JSpec.parse(topo)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.n_layers, t.n_macs, t.n_params) == \
            (j.n_layers, j.n_macs, j.n_params)


@pytest.mark.parametrize("name", NAMES)
def test_make_dataset_is_well_formed(name):
    app = TR.get_app(name)
    g = torch.Generator().manual_seed(0)
    xtr, ytr, xte, yte = TR.make_dataset(app, g, 64, 32)
    assert xtr.shape == (64, app.n_in) and xte.shape == (32, app.n_in)
    assert ytr.shape == (64, app.n_out) and yte.shape == (32, app.n_out)
    for a in (xtr, ytr, xte, yte):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
    assert xtr.min() >= -1.0 - 1e-5 and xtr.max() <= 1.0 + 1e-5
    again = TR.make_dataset(app, 0, 64, 32, device="cpu")
    for a, b in zip((xtr, ytr, xte, yte), again):
        assert torch.equal(a, b)
