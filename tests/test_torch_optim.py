"""The PyTorch port's optimizers against the JAX reference
(``repro.optim``): AdamW, RMSprop, global-norm clipping and the cosine
schedule on the same numpy trees, within 1e-6; the weight-decay mask of
the per-layer split model against the reference's update of its stacked
tree; and the ports of tests/test_runtime.py's optimizer and straggler
cases."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import optim as J  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import optim as T  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import _split, decay_mask, params_from_jax  # noqa: E402
from repro_torch.runtime.trainer import StragglerMonitor  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-6


def _tree(seed):
    """Leaves of rank 0 to 3: which of them AdamW decays depends on the
    rank."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 6), "b": (6,), "stack": (2, 3, 5), "s": ()}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax(weight_decay):
    params = _tree(0)
    jp, tp = _j(params), _t(params)
    jo, to = J.adamw_init(jp), T.adamw_init(tp)
    for i in range(5):
        g = _tree(10 + i)
        lr = 1e-2 * (i + 1)
        jp, jo = J.adamw_update(jp, _j(g), jo, jnp.asarray(i, jnp.int32),
                                lr=lr, weight_decay=weight_decay)
        tp, to = T.adamw_update(tp, _t(g), to,
                                torch.tensor(i, dtype=torch.int32), lr=lr,
                                weight_decay=weight_decay)
        _close(tp, jp)
        _close(to["m"], jo["m"])
        _close(to["v"], jo["v"])
    assert all(v.dtype == torch.float32 for v in to["m"].values())


def test_adamw_bf16_params_keep_f32_moments():
    params = {k: v for k, v in _tree(1).items() if k != "s"}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in params.items()}
    jo, to = J.adamw_init(jp), T.adamw_init(tp)
    g = {k: v for k, v in _tree(2).items() if k != "s"}
    jp, jo = J.adamw_update(jp, {k: jnp.asarray(v, jnp.bfloat16)
                                 for k, v in g.items()}, jo,
                            jnp.asarray(3, jnp.int32), lr=1e-2)
    tp, to = T.adamw_update(tp, {k: torch.from_numpy(v).to(torch.bfloat16)
                                 for k, v in g.items()}, to,
                            torch.tensor(3, dtype=torch.int32), lr=1e-2)
    for k in params:
        assert tp[k].dtype == torch.bfloat16
        assert to["m"][k].dtype == to["v"][k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32),
                                   rtol=TOL, atol=TOL, err_msg=k)
    _close(to["m"], jo["m"])
    _close(to["v"], jo["v"])


def test_rmsprop_matches_jax():
    params = _tree(3)
    jp, tp = _j(params), _t(params)
    jo, to = J.rmsprop_init(jp), T.rmsprop_init(tp)
    for i in range(4):
        g = _tree(20 + i)
        jp, jo = J.rmsprop_update(jp, _j(g), jo, lr=1e-2)
        tp, to = T.rmsprop_update(tp, _t(g), to, lr=1e-2)
        _close(tp, jp)
        _close(to["ms"], jo["ms"])


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(4)
    jg, jn = J.clip_by_global_norm(_j(g), max_norm)
    tg, tn = T.clip_by_global_norm(_t(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    assert tn.dtype == torch.float32
    _close(tg, jg)


@pytest.mark.parametrize("warmup", [0, 10])
def test_cosine_schedule_matches_jax(warmup):
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        j = J.cosine_schedule(jnp.asarray(s, jnp.int32), base_lr=3e-4,
                              warmup=warmup, total=100)
        t = T.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                              base_lr=3e-4, warmup=warmup, total=100)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t), float(j), rtol=TOL, atol=1e-12,
                                   err_msg=f"step {s}")


def _smoke(arch):
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke_config(get_config(arch))
    if arch == "internlm2-1.8b":
        jcfg, tcfg = (dataclasses.replace(c, approx=dataclasses.replace(
            c.approx, enable=True)) for c in (jcfg, tcfg))
    return jcfg, tcfg


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "xlstm-1.3b"])
def test_decay_mask_follows_the_stacked_reference(arch):
    """The reference decays its leaves of rank >= 2, and they are stacked
    over layers: a per-layer norm scale or bias is decayed there, so the
    split model must decay it too.  One AdamW step of the converted smoke
    tree under ``decay_mask`` equals the reference's step of the stacked
    tree."""
    jcfg, tcfg = _smoke(arch)
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    mask = decay_mask(tcfg, model)
    assert mask["ln_f.scale"] is False
    if arch == "internlm2-1.8b":
        assert mask["blocks.1.ln1.scale"] and mask["blocks.0.approx.a_b1"]
    else:
        assert mask["slstm.0.core.b"] and mask["mlstm.1.0.core.norm_scale"]
        assert mask["ln_f.bias"] is False
    # the rank rule on the split tensors would exempt these
    assert any(p.ndim < 2 and mask[k] for k, p in model.named_parameters())

    rng = np.random.default_rng(7)
    jgrads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), jparams)
    step = jnp.asarray(2, jnp.int32)
    jnew, jopt = J.adamw_update(jparams, jgrads, J.adamw_init(jparams), step,
                                lr=0.05, weight_decay=0.5)
    tp = {k: p.detach().clone() for k, p in model.named_parameters()}
    tg = _split(tcfg, jax.tree.map(np.asarray, jgrads))
    tnew, topt = T.adamw_update(tp, tg, T.adamw_init(tp),
                                torch.tensor(2, dtype=torch.int32), lr=0.05,
                                weight_decay=0.5, decay=mask)
    want = _split(tcfg, jax.tree.map(np.asarray, jnew))
    assert want.keys() == tnew.keys()
    _close(tnew, want)
    _close(topt["v"], _split(tcfg, jax.tree.map(np.asarray, jopt["v"])))


# ---- ports of tests/test_runtime.py's optimizer cases ---------------------

def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    opt = T.adamw_init(params)
    step = torch.zeros((), dtype=torch.int32)
    for i in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt = T.adamw_update(params, grads, opt, step + i, lr=5e-2,
                                     weight_decay=0.0)
    assert float((params["w"] ** 2).sum()) < 1e-2


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = T.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)


def test_cosine_schedule_shape():
    lrs = [float(T.cosine_schedule(torch.tensor(s), base_lr=1.0, warmup=10,
                                   total=100)) for s in range(100)]
    assert lrs[0] < lrs[9]                 # warmup rises
    assert max(lrs) == pytest.approx(1.0, rel=1e-2)
    assert lrs[-1] < 0.01                  # decays to ~0


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor()
    flags = [mon.observe(1.0) for _ in range(10)]
    assert not any(flags)
    assert mon.observe(10.0) is True
    assert mon.slow_steps == 1
