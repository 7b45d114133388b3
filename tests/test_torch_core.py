"""The paper pipeline's building blocks in the PyTorch port against the JAX
reference (``repro/core``): both packages get the same numpy inputs and
converted parameters.

Floats are held within the stated tolerances (the MLP forward 1e-6, the
losses and their gradients 1e-5, ``train_mlp`` after 1 and 10 epochs
1e-4, the quality metrics 1e-6); the NPU cost model is plain Python and
equal; the label functions and the k-means assignment of
``_error_clusters`` (given the reference's centroid indices) are held
exactly.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.apps import registry as JR  # noqa: E402
from repro.core import mcma as JMC  # noqa: E402
from repro.core import mlp as JM  # noqa: E402
from repro.core import npu_model as JN  # noqa: E402
from repro.core import quality as JQ  # noqa: E402
from repro_torch.apps import registry as TR  # noqa: E402
from repro_torch.convert import (mlp_params_from_jax,  # noqa: E402
                                 mlp_params_to_numpy)
from repro_torch.core import mcma as TMC  # noqa: E402
from repro_torch.core import mlp as TM  # noqa: E402
from repro_torch.core import npu_model as TN  # noqa: E402
from repro_torch.core import quality as TQ  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

NAMES = sorted(JR.APPS)
FWD_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)


def _params(spec, seed):
    """Glorot-scaled numpy parameters of ``spec`` (the reference's layout)
    with nonzero biases."""
    rng = np.random.default_rng(seed)
    out = []
    for a, b in zip(spec.sizes[:-1], spec.sizes[1:]):
        s = (6.0 / (a + b)) ** 0.5
        out.append({"w": rng.uniform(-s, s, (a, b)).astype(np.float32),
                    "b": rng.normal(0, 0.1, b).astype(np.float32)})
    return out


def _jp(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


def _tp(params):
    return mlp_params_from_jax(params, device="cpu")


def _np(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _tspec(spec):
    return TM.MLPSpec(spec.sizes, spec.hidden_act, spec.out_act)


def _x(n, d, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(
        np.float32)


def _close_params(got, want, tol):
    for g, w in zip(mlp_params_to_numpy(got), _np(want)):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], w[k], **tol)


# ---------------------------------------------------------------------------
# the MLP substrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_apply_mlp_and_logits_match_jax(name):
    app = JR.get_app(name)
    x = _x(96, app.n_in, 1)
    for i, spec in enumerate((app.approx_spec, app.cls_spec(2),
                              app.cls_spec(4))):
        p = _params(spec, 10 + i)
        for jf, tf in ((JM.apply_mlp, TM.apply_mlp),
                       (JM.mlp_logits, TM.mlp_logits)):
            want = np.asarray(jf(_jp(p), jnp.asarray(x), spec))
            got = tf(_tp(p), torch.from_numpy(x), _tspec(spec))
            np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("act", sorted(TM._ACTS))
def test_activations_match_jax(act):
    """Every hidden/output activation (gelu is JAX's tanh approximation)."""
    spec = JM.MLPSpec((5, 7, 3), hidden_act=act, out_act=act)
    p, x = _params(spec, 3), 2.0 * _x(64, 5, 4)
    want = np.asarray(JM.apply_mlp(_jp(p), jnp.asarray(x), spec))
    got = TM.apply_mlp(_tp(p), torch.from_numpy(x), _tspec(spec))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_init_mlp_draws_glorot_in_layer_order():
    spec = TM.MLPSpec((6, 8, 4, 1))
    p = TM.init_mlp(torch.Generator().manual_seed(5), spec)
    g = torch.Generator().manual_seed(5)
    for layer, (a, b) in zip(p, zip(spec.sizes[:-1], spec.sizes[1:])):
        s = (6.0 / (a + b)) ** 0.5
        want = torch.rand(a, b, generator=g) * (2 * s) - s
        assert torch.equal(layer["w"], want)
        assert layer["b"].shape == (b,) and not layer["b"].any()
        assert layer["w"].abs().max() <= s
    q = TM.init_mlp(torch.Generator().manual_seed(5), spec, scale=0.3)
    assert all(float(layer["w"].abs().max()) <= 0.3 for layer in q)
    assert all(layer["w"].dtype == torch.float32 for layer in q)


def _loss_case(kind, weighted, seed=7):
    app = JR.get_app("blackscholes")
    rng = np.random.default_rng(seed)
    x = _x(200, 6, seed)
    if kind == "mse":
        spec, y = app.approx_spec, rng.normal(size=(200, 1)).astype(
            np.float32)
    else:
        spec, y = app.cls_spec(3), rng.integers(0, 3, 200).astype(np.int32)
    w = (rng.random(200) * (rng.random(200) < 0.7)).astype(np.float32) \
        if weighted else None
    return spec, _params(spec, seed), x, y, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["mse", "xent"])
def test_losses_and_gradients_match_jax(kind, weighted):
    spec, p, x, y, w = _loss_case(kind, weighted)
    jf = JM.mse_loss if kind == "mse" else JM.xent_loss
    tf = TM.mse_loss if kind == "mse" else TM.xent_loss
    jw = None if w is None else jnp.asarray(w)
    jl, jg = jax.value_and_grad(jf)(_jp(p), jnp.asarray(x), jnp.asarray(y),
                                    spec, jw)
    tp = [{k: v.requires_grad_(True) for k, v in layer.items()}
          for layer in _tp(p)]
    tl = tf(tp, torch.from_numpy(x), torch.from_numpy(y), _tspec(spec),
            None if w is None else torch.from_numpy(w))
    leaves = [layer[k] for layer in tp for k in ("w", "b")]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), **GRAD_TOL)
    want = [np.asarray(layer[k]) for layer in jg for k in ("w", "b")]
    for g, wv in zip(tg, want):
        np.testing.assert_allclose(g.numpy(), wv, **GRAD_TOL)


@pytest.mark.parametrize("n_classes,labels", [
    (2, [0, 1, 1, 1, 0, 1, 1, 1]),
    (4, [0, 1, 1, 3, 3, 3, 3, 3, 1, 0]),      # class 2 absent
    (3, [2] * 9),                             # one class only
])
def test_balanced_weights_match_jax(n_classes, labels):
    lab = np.asarray(labels, np.int32)
    want = np.asarray(JM.balanced_weights(jnp.asarray(lab), n_classes))
    got = TM.balanced_weights(torch.from_numpy(lab), n_classes)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    lab = np.random.default_rng(0).integers(0, 5, 1000).astype(np.int32)
    np.testing.assert_allclose(
        TM.balanced_weights(torch.from_numpy(lab), 5).numpy(),
        np.asarray(JM.balanced_weights(jnp.asarray(lab), 5)),
        rtol=1e-6, atol=1e-6)


def test_rmsprop_update_matches_jax_bitwise():
    rng = np.random.default_rng(2)
    shapes = [(6, 8), (8,), (8, 1), (1,)]
    p, g, m = ([rng.normal(size=s).astype(np.float32) for s in shapes]
               for _ in range(3))
    m = [np.abs(a) for a in m]
    jp, jm = JM._rmsprop_update(*(list(map(jnp.asarray, a))
                                  for a in (p, g, m)), 3e-3)
    tp, tm = TM._rmsprop_update(*([torch.from_numpy(a.copy()) for a in b]
                                  for b in (p, g, m)), 3e-3)
    for got, want in zip(tp + tm, list(jp) + list(jm)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["mse", "xent"])
def test_train_mlp_matches_jax(kind):
    """From one converted init, with per-sample weights, after 1 and 10
    full-batch RMSprop epochs."""
    spec, p, x, y, w = _loss_case(kind, True, seed=11)
    for epochs in (1, 10):
        want = JM.train_mlp(_jp(p), jnp.asarray(x), jnp.asarray(y), spec,
                            weights=jnp.asarray(w), loss=kind,
                            epochs=epochs, lr=3e-3)
        start = _tp(p)
        got = TM.train_mlp(start, torch.from_numpy(x), torch.from_numpy(y),
                           _tspec(spec), weights=torch.from_numpy(w),
                           loss=kind, epochs=epochs, lr=3e-3)
        _close_params(got, want, TRAIN_TOL)
        # the caller's parameters are not modified
        _close_params(start, _jp(p), dict(rtol=0, atol=0))
        assert not any(v.requires_grad for layer in got for v in
                       layer.values())


def test_mlp_params_convert_both_ways():
    p = _params(JM.MLPSpec((2, 4, 4, 1)), 0)
    back = mlp_params_to_numpy(_tp(p))
    for a, b in zip(back, p):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# quality and the NPU cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_per_sample_error_matches_jax(name):
    japp, tapp = JR.get_app(name), TR.get_app(name)
    rng = np.random.default_rng(3)
    if japp.err_kind == "class":
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 128)]
        pred = rng.normal(size=y.shape).astype(np.float32)
        pred[:4] = [[1.0, 1.0]] * 4              # argmax ties: the first
    else:
        y = rng.normal(size=(128, japp.n_out)).astype(np.float32)
        pred = (y + rng.normal(scale=0.05, size=y.shape)).astype(np.float32)
    want = np.asarray(JQ.per_sample_error(japp, jnp.asarray(pred),
                                          jnp.asarray(y)))
    got = TQ.per_sample_error(tapp, torch.from_numpy(pred),
                              torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("with_choice", [False, True])
def test_confusion_metrics_match_jax(with_choice):
    japp, tapp = JR.get_app("bessel"), TR.get_app("bessel")
    rng = np.random.default_rng(4)
    n, n_approx = 300, 3
    disp = rng.random(n) < 0.6
    err_d = (rng.random(n) * 0.1).astype(np.float32)
    err_d[:3] = japp.error_bound                 # exactly at the bound
    err_b = np.minimum(err_d, rng.random(n) * 0.1).astype(np.float32)
    choice = np.where(disp, rng.integers(0, n_approx, n), n_approx).astype(
        np.int32) if with_choice else None
    want = JQ.confusion_metrics(japp, jnp.asarray(disp), jnp.asarray(err_d),
                                jnp.asarray(err_b), n_approx,
                                None if choice is None
                                else jnp.asarray(choice))
    got = TQ.confusion_metrics(tapp, torch.from_numpy(disp),
                               torch.from_numpy(err_d),
                               torch.from_numpy(err_b), n_approx,
                               None if choice is None
                               else torch.from_numpy(choice))
    for field in dataclasses.fields(want):
        np.testing.assert_allclose(getattr(got, field.name),
                                   getattr(want, field.name), **FWD_TOL)
    assert got.row() == want.row()
    # nothing dispatched: the guards keep every metric finite
    none = np.zeros(n, bool)
    empty = TQ.confusion_metrics(tapp, torch.from_numpy(none),
                                 torch.from_numpy(err_d),
                                 torch.from_numpy(err_b), n_approx)
    assert dataclasses.asdict(empty) == dataclasses.asdict(
        JQ.confusion_metrics(japp, jnp.asarray(none), jnp.asarray(err_d),
                             jnp.asarray(err_b), n_approx))


@pytest.mark.parametrize("name", NAMES)
def test_npu_cost_model_matches_jax(name):
    japp, tapp = JR.get_app(name), TR.get_app(name)
    for inv in (0.0, 0.37, 1.0):
        for n_approx in (1, 3, 8):
            for kw in (dict(), dict(multiclass=True, switch_rate=0.5),
                       dict(n_classifier_calls=2.25)):
                assert dataclasses.asdict(
                    TN.cost(tapp, inv, n_approx=n_approx, **kw)) == \
                    dataclasses.asdict(
                        JN.cost(japp, inv, n_approx=n_approx, **kw))
    assert dataclasses.asdict(TN.cpu_only(tapp)) == \
        dataclasses.asdict(JN.cpu_only(japp))
    spec = tapp.approx_spec
    assert TN.nn_cycles(spec) == JN.nn_cycles(japp.approx_spec)
    assert TN.nn_energy(spec) == JN.nn_energy(japp.approx_spec)


# ---------------------------------------------------------------------------
# MCMA's labels and error clusters (exact)
# ---------------------------------------------------------------------------

BOUND = 0.05


def _label_cases():
    """(errs (n_approx, n), prev) cases with ties, values at the bound,
    all-unsafe columns and hysteresis that crosses the bound."""
    b = np.float32(BOUND)
    hand = np.array([
        # tie under the bound | tie at the bound | all unsafe | one at bound
        [0.01, b, 0.2, 0.06, b, 0.03, 0.055, 0.035],
        [0.01, b, 0.3, b, 0.07, 0.03, 0.058, 0.036],
        [0.02, 0.06, 0.4, 0.07, b, 0.031, 0.06, 0.04],
    ], np.float32)
    # column 6: every error above the bound, but the owner's (approximator
    # 0) adjusted error 0.055 - 0.2 * 0.05 = 0.045 crosses it: hysteresis
    # makes the sample safe; column 7: owner 2 (0.04) keeps it against a
    # 0.035 challenger, which is within 20 % of the bound
    prev = np.array([1, 0, 2, 3, 3, 2, 0, 2], np.int32)
    rng = np.random.default_rng(9)
    rnd = (rng.random((4, 200)) * 0.1).astype(np.float32)
    rnd[:, :20] = np.round(rnd[:, :20], 2)       # many exact ties
    rnd[:, 20:30] = b
    rnd[:, 30:40] = 0.5
    rprev = rng.integers(0, 5, 200).astype(np.int32)
    return [(hand, None), (hand, prev), (rnd, None), (rnd, rprev)]


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("fn", ["_labels_complementary",
                                "_labels_competitive"])
def test_labels_match_jax_exactly(fn, case):
    errs, prev = _label_cases()[case]
    want = np.asarray(getattr(JMC, fn)(
        jnp.asarray(errs), BOUND, None if prev is None else jnp.asarray(prev)))
    got = getattr(TMC, fn)(torch.from_numpy(errs), BOUND,
                           None if prev is None else torch.from_numpy(prev))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == 1 and fn == "_labels_competitive":
        assert want[6] == 0 and want[7] == 2     # hysteresis, as designed
    if case == 0:
        assert want[2] == errs.shape[0]          # all unsafe -> nC


def _cluster_case(seed, n=384):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    x[:, 1] *= 0.25                               # unequal spreads
    err = (np.abs(np.sin(3 * x[:, 0])) * 0.1
           + rng.random(n) * 0.01).astype(np.float32)
    return x, err


@pytest.mark.parametrize("seed", [0, 1])
def test_error_clusters_match_jax_exactly(seed, monkeypatch):
    x, err = _cluster_case(seed)
    key, k = jax.random.PRNGKey(seed), 5
    want = np.asarray(JMC._error_clusters(key, jnp.asarray(x),
                                          jnp.asarray(err), k))
    idx = np.asarray(jax.random.choice(key, x.shape[0], (k,), replace=False))

    def given(gen, n, kk):
        assert (n, kk) == (x.shape[0], k)
        return torch.from_numpy(idx.copy())
    monkeypatch.setattr(TMC, "_centroid_indices", given)
    got = TMC._error_clusters(torch.Generator().manual_seed(0),
                              torch.from_numpy(x), torch.from_numpy(err), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1


def test_error_clusters_use_population_std(monkeypatch):
    """``x.std(0)`` and ``err.std()`` in JAX are ddof 0; torch's default
    (``correction=1``) would whiten differently."""
    seen = []
    std = torch.Tensor.std

    def spy(self, *a, **kw):
        seen.append(kw.get("correction", "default"))
        return std(self, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "std", spy)
    x, err = _cluster_case(2, n=64)
    TMC._error_clusters(torch.Generator().manual_seed(0), torch.from_numpy(x),
                        torch.from_numpy(err), 3, iters=2)
    assert seen == [0, 0]


def test_centroid_indices_are_distinct_draws():
    g = torch.Generator().manual_seed(3)
    idx = TMC._centroid_indices(g, 50, 8)
    assert idx.shape == (8,) and len(set(idx.tolist())) == 8
    assert int(idx.min()) >= 0 and int(idx.max()) < 50
    again = TMC._centroid_indices(torch.Generator().manual_seed(3), 50, 8)
    assert torch.equal(idx, again)
