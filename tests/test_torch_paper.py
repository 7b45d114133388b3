"""The paper's co-training loops in the PyTorch port against the JAX
reference: ``train_one_pass``, ``train_iterative`` (the three
selections), ``train_mcca``, ``train_mcma`` (both schemes) and
``train_library``, on the reference's ``make_dataset`` data converted to
torch (512 training rows, 20 epochs, 2 to 3 iterations).

The reference's key schedule is replayed: its ``init_mlp`` results are
queued and the port's ``init_mlp`` pops them (asserting the spec and
scale of each), and ``train_library``'s k-means seeds are the reference's
indices.  Then the reference's trainer is injected into the port's loop
(the port's ``train_mlp`` becomes a numpy round trip through
``repro.core.mlp.train_mlp``), so the loop's own arithmetic stands alone:
territories, guards, labels, the order of draws and ``history``.
``history`` and the class of every row are held exactly, parameters and
``evaluate``'s metrics within 3e-5.  Then the port's own trainer runs the
loops end to end from the same inits: its metrics lie within a band of
the reference's (below), and MCMA's invocation is at least one-pass's
minus 0.02, the reference's headline check.  The two example twins run
at tiny sizes on the CPU.
"""
import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.apps import registry as JR  # noqa: E402
from repro.core import iterative as JI  # noqa: E402
from repro.core import mcca as JC  # noqa: E402
from repro.core import mcma as JMC  # noqa: E402
from repro.core import mlp as JM  # noqa: E402
from repro.core import onepass as JO  # noqa: E402
from repro_torch.apps import registry as TR  # noqa: E402
from repro_torch.convert import (mlp_params_from_jax,  # noqa: E402
                                 mlp_params_to_numpy)
from repro_torch.core import iterative as TI  # noqa: E402
from repro_torch.core import mcca as TC  # noqa: E402
from repro_torch.core import mcma as TMC  # noqa: E402
from repro_torch.core import onepass as TO  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=3e-5, atol=3e-5)
N_TRAIN, N_TEST, EPOCHS, LR = 512, 256, 20, 1e-2
# The port's own trainer against the reference's, from the same inits:
# the largest gap of any metric over every method here was 5.1e-5 (an
# err/bound), with every row's class equal; the band allows one flipped
# row in 256 test rows.
BAND = 1.0 / N_TEST + 1e-6

# method -> (reference module, port module, function, kwargs, app)
METHODS = {
    "one_pass": (JO, TO, "train_one_pass", {}, "blackscholes"),
    "iterative_AC": (JI, TI, "train_iterative",
                     dict(iters=2, selection="AC"), "blackscholes"),
    "iterative_C": (JI, TI, "train_iterative",
                    dict(iters=2, selection="C"), "blackscholes"),
    "iterative_A": (JI, TI, "train_iterative",
                    dict(iters=2, selection="A"), "blackscholes"),
    "mcca": (JC, TC, "train_mcca", dict(max_pairs=3, iters=2),
             "blackscholes"),
    "mcma_competitive": (JMC, TMC, "train_mcma",
                         dict(n_approx=3, scheme="competitive", iters=3),
                         "blackscholes"),
    "mcma_complementary": (JMC, TMC, "train_mcma",
                           dict(n_approx=3, scheme="complementary",
                                iters=3), "blackscholes"),
    "library": (JMC, TMC, "train_library",
                dict(library_size=4, iters=2, cluster_iters=10),
                "blackscholes"),
}


@functools.cache
def _data(name):
    """The reference's dataset for ``name`` as numpy arrays."""
    return tuple(np.array(a) for a in JR.make_dataset(
        JR.get_app(name), jax.random.PRNGKey(0), N_TRAIN, N_TEST))


def _np(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _ref_train(params, x, y, spec, *, weights=None, loss="mse",
               epochs=1500, lr=1e-2):
    """The port's ``train_mlp`` signature, computed by the reference."""
    jspec = JM.MLPSpec(spec.sizes, spec.hidden_act, spec.out_act)
    out = JM.train_mlp(
        [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
         for layer in params], jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
        jspec, weights=None if weights is None
        else jnp.asarray(weights.numpy()), loss=loss, epochs=epochs, lr=lr)
    return mlp_params_from_jax(_np(out), device="cpu")


@functools.cache
def _reference(method):
    """The reference's model, and the queue of its ``init_mlp`` results
    (spec sizes, scale, parameters) in call order."""
    jmod, _, fn, kw, app_name = METHODS[method]
    xtr, ytr, _, _ = _data(app_name)
    queue = []
    real = jmod.init_mlp

    def recording(key, spec, dtype=jnp.float32, scale=None):
        p = real(key, spec, dtype, scale)
        queue.append((spec.sizes, scale, _np(p)))
        return p
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "init_mlp", recording)
        model = getattr(jmod, fn)(JR.get_app(app_name), jax.random.PRNGKey(1),
                                  jnp.asarray(xtr), jnp.asarray(ytr),
                                  epochs=EPOCHS, lr=LR, **kw)
    return model, queue


def _run_port(method, monkeypatch, *, inject_trainer):
    """The port's model from the reference's inits (and, with
    ``inject_trainer``, the reference's trainer)."""
    jmod, tmod, fn, kw, app_name = METHODS[method]
    _, queue = _reference(method)
    queue = list(queue)

    def popping(gen, spec, dtype=torch.float32, scale=None):
        sizes, sc, p = queue.pop(0)
        assert spec.sizes == sizes and scale == sc, (spec, sizes, scale, sc)
        return mlp_params_from_jax(p, device="cpu")
    monkeypatch.setattr(tmod, "init_mlp", popping)
    if inject_trainer:
        monkeypatch.setattr(tmod, "train_mlp", _ref_train)
    if fn == "train_library":
        n, k = N_TRAIN, kw["library_size"]
        idx = np.asarray(jax.random.choice(
            jax.random.split(jax.random.PRNGKey(1), k + 3)[2], n, (k,),
            replace=False))

        def given(gen, nn, kk):
            assert (nn, kk) == (n, k)
            return torch.from_numpy(idx.copy())
        monkeypatch.setattr(tmod, "_centroid_indices", given)
    xtr, ytr, _, _ = _data(app_name)
    model = getattr(tmod, fn)(TR.get_app(app_name),
                              torch.Generator().manual_seed(1),
                              torch.from_numpy(xtr), torch.from_numpy(ytr),
                              epochs=EPOCHS, lr=LR, **kw)
    assert not queue, "the port drew fewer inits than the reference"
    return model


def _params_of(model):
    if hasattr(model, "pairs"):
        return [p for pair in model.pairs for p in pair]
    if hasattr(model, "history"):
        return [*model.a_params, model.c_params]
    return [model.a_params, model.c_params]


def _classes(model, x, torch_side):
    """Each row's routing decision: MCMA's class, MCCA's chosen pair, a
    pair's accept bit."""
    if hasattr(model, "history"):
        out = model.classify(x)
    elif hasattr(model, "pairs"):
        out = model.dispatch(x)[1]
    else:
        out = model.dispatch(x)
    return out.numpy() if torch_side else np.asarray(out)


def _metrics(model, x, y):
    return dataclasses.asdict(model.evaluate(x, y))


@pytest.mark.parametrize("method", sorted(METHODS))
def test_loop_matches_reference_with_its_trainer(method, monkeypatch):
    ref, _ = _reference(method)
    got = _run_port(method, monkeypatch, inject_trainer=True)
    app_name = METHODS[method][4]
    xtr, _, xte, yte = _data(app_name)
    if hasattr(ref, "history"):
        assert got.history == ref.history
        assert got.n_approx == ref.n_approx and got.scheme == ref.scheme
        assert len(got.history) == METHODS[method][3]["iters"]
    if hasattr(ref, "pairs"):
        assert len(got.pairs) == len(ref.pairs)
        np.testing.assert_allclose(
            float(got.classifiers_consulted(torch.from_numpy(xte))),
            float(ref.classifiers_consulted(jnp.asarray(xte))), **TOL)
    for x in (xtr, xte):
        np.testing.assert_array_equal(
            _classes(got, torch.from_numpy(x), True),
            _classes(ref, jnp.asarray(x), False))
    for gp, rp in zip(_params_of(got), _params_of(ref), strict=True):
        for g, r in zip(mlp_params_to_numpy(gp), _np(rp), strict=True):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], r[k], **TOL)
    want = _metrics(ref, jnp.asarray(xte), jnp.asarray(yte))
    have = _metrics(got, torch.from_numpy(xte), torch.from_numpy(yte))
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(have[k], want[k], **TOL)


def test_loops_with_the_ports_trainer_stay_in_band(monkeypatch):
    """Every loop end to end on the port's own trainer, from the
    reference's inits: each metric within ``BAND`` of the reference's,
    and the headline check."""
    inv = {}
    for method in sorted(METHODS):
        ref, _ = _reference(method)
        with pytest.MonkeyPatch.context() as mp:
            got = _run_port(method, mp, inject_trainer=False)
        _, _, xte, yte = _data(METHODS[method][4])
        want = _metrics(ref, jnp.asarray(xte), jnp.asarray(yte))
        have = _metrics(got, torch.from_numpy(xte), torch.from_numpy(yte))
        for k in want:
            np.testing.assert_allclose(have[k], want[k], rtol=0, atol=BAND,
                                       err_msg=f"{method} {k}")
        if hasattr(ref, "history"):
            np.testing.assert_allclose(got.history, ref.history, rtol=0,
                                       atol=1.0 / N_TRAIN + 1e-6)
        inv[method] = have["invocation"]
    assert inv["mcma_competitive"] >= inv["one_pass"] - 0.02, inv


def test_models_from_reference_parameters_compute_what_it_computes():
    """``BinaryPair``, ``MCCA`` and ``MCMA`` built from the reference's
    trained parameters (converted leaf by leaf) route and evaluate as the
    reference's objects do."""
    tapp = TR.get_app("blackscholes")
    _, _, xte, yte = _data("blackscholes")
    for method in ("one_pass", "mcca", "mcma_competitive"):
        ref, _ = _reference(method)
        conv = lambda p: mlp_params_from_jax(_np(p), device="cpu")  # noqa
        if method == "one_pass":
            got = TO.BinaryPair(tapp, conv(ref.a_params), conv(ref.c_params))
        elif method == "mcca":
            got = TC.MCCA(tapp, [(conv(a), conv(c)) for a, c in ref.pairs])
        else:
            got = TMC.MCMA(tapp, [conv(a) for a in ref.a_params],
                           conv(ref.c_params), list(ref.history), ref.scheme)
            np.testing.assert_allclose(
                got.approximator_errors(torch.from_numpy(xte),
                                        torch.from_numpy(yte)).numpy(),
                np.asarray(ref.approximator_errors(jnp.asarray(xte),
                                                   jnp.asarray(yte))), **TOL)
        np.testing.assert_array_equal(
            _classes(got, torch.from_numpy(xte), True),
            _classes(ref, jnp.asarray(xte), False))
        want = _metrics(ref, jnp.asarray(xte), jnp.asarray(yte))
        have = _metrics(got, torch.from_numpy(xte), torch.from_numpy(yte))
        for k in want:
            np.testing.assert_allclose(have[k], want[k], **TOL)


# ---------------------------------------------------------------------------
# the example twins
# ---------------------------------------------------------------------------

def _example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = {"quickstart_torch": ["--n-train", "384", "--n-test", "192",
                             "--epochs", "15"],
        "approx_bessel_torch": ["--n-train", "384", "--n-test", "192",
                                "--epochs", "15"]}


@pytest.mark.parametrize("name", sorted(TINY))
def test_example_runs_on_cpu(name, capsys):
    _example(name).main(TINY[name] + ["--device", "cpu"])
    out = capsys.readouterr().out
    if name == "quickstart_torch":
        assert out.count("invocation=") == 3 and "mcma-competitive" in out
    else:
        assert "== complementary ==" in out and "== competitive ==" in out
        assert "switched-MLP on" in out


@pytest.mark.parametrize("name", sorted(TINY))
def test_example_without_device_raises_when_there_is_no_gpu(name,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(TINY[name])
