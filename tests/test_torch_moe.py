"""The PyTorch port's MoE FFN against the JAX reference's
``repro.models.moe.moe_fwd``, from the reference's ``init_moe``
parameters converted leaf by leaf, on moonshot-v1-16b-a3b's smoke config
widened to 8 experts, top-3 (d 64, d_ff 128).

Three settings of the capacity and the token groups: capacity factor
1.25 with drops occurring in one group; ``scan_chunk`` splitting the 64
tokens into 4 groups (the capacity is per group); ``scan_chunk`` not
dividing them (one group).  Held in each: the routing exactly (the
top-k's ``gate_idx`` with the reference's tie rule, the sort ``order``,
``keep`` and ``slot``, recomputed here from the reference's own lines
for the first group), the outputs within 3e-5 in float32 and 2e-2 in
bfloat16 (against the reference evaluated op by op), the aux loss
within 1e-6, and the gradients of the router and of every expert leaf
within 1e-4 (under ``remat`` bitwise equal to without).  The combine
gives bitwise-equal outputs across calls.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "moonshot-v1-16b-a3b"
B, S = 2, 32
# name -> (capacity_factor, scan_chunk); B * S = 64 tokens
SETTINGS = {"drops": (1.25, 32768), "groups": (1.25, 16),
            "one_group": (1.25, 24)}


def _cfgs(setting, dtype="float32"):
    cf, ck = SETTINGS[setting]

    def f(cfg):
        return dataclasses.replace(
            cfg, param_dtype=dtype, act_dtype=dtype,
            moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=3,
                                    capacity_factor=cf, scan_chunk=ck))
    return f(jsmoke(jget_config(ARCH))), f(smoke_config(get_config(ARCH)))


def _params(jcfg, tcfg, seed=0):
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = TMOE.MoE(tcfg, "cpu")
    tp.load_state_dict({k: to_torch(np.asarray(v)) for k, v in jp.items()})
    return jp, tp


def _x(cfg, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _jax_routing(jcfg, router, xt):
    """The reference's routing lines of ``_moe_group`` on one group."""
    t = xt.shape[0]
    e, k = jcfg.moe.n_experts, jcfg.moe.top_k
    cap = min(int(jcfg.moe.capacity_factor * t * k / e) + 1, t)
    logits = jnp.dot(xt, router.astype(xt.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, -1)
    _, gate_idx = jax.lax.top_k(probs, k)
    order, e_sorted, rank, _ = JD.class_sort_ranks(gate_idx.reshape(t * k), e)
    keep, slot = JD.capacity_slots(e_sorted, rank, cap, n_local=e)
    return gate_idx, order, keep, slot, cap


def _group_rows(cfg):
    """Rows of the first token group ``_moe_chunked`` forms."""
    t, ck = B * S, cfg.moe.scan_chunk
    return ck if ck and t > ck and t % ck == 0 else t


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_moe_routing_outputs_and_aux_match_jax(setting):
    jcfg, tcfg = _cfgs(setting)
    jp, tp = _params(jcfg, tcfg)
    x = _x(tcfg)
    rows = _group_rows(tcfg)
    xt = x.reshape(B * S, -1)[:rows]
    gate_idx, order, keep, slot, cap = _jax_routing(jcfg, jp["router"],
                                                    jnp.asarray(xt))
    with torch.no_grad():
        r = TMOE.route(tcfg, tp.router, torch.from_numpy(xt))
    assert r.cap == cap
    assert r.gate_idx.dtype == r.order.dtype == r.slot.dtype == torch.int32
    for name, got, want in (("gate_idx", r.gate_idx, gate_idx),
                            ("order", r.order, order), ("keep", r.keep, keep),
                            ("slot", r.slot, slot)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    if setting == "drops":          # the capacity drops some choices
        assert 0 < int((~r.keep).sum()) < rows * tcfg.moe.top_k
    jy, jaux = JMOE.moe_fwd(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        ty, taux = TMOE.moe_fwd(tcfg, tp, torch.from_numpy(x))
    assert ty.shape == (B, S, tcfg.d_model) and ty.dtype == torch.float32
    _close(ty, jy, 3e-5, "moe output")
    _close(taux, jaux, 1e-6, "aux loss")


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_moe_bf16_outputs_match_jax(setting):
    """In bfloat16 the reference's source rounds the router logits to
    bf16 before the f32 softmax, and so does the port; compiled (under
    ``jit``, or inside the ``lax.scan`` of its token groups) XLA folds
    that rounding away and one token of these 64 takes another expert
    (0.63 off).  So the port is held to the reference's ``moe_fwd``
    evaluated op by op (``jax.disable_jit``), its source as written."""
    jcfg, tcfg = _cfgs(setting, "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    x = _x(tcfg)
    with jax.disable_jit():
        jy, jaux = JMOE.moe_fwd(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        ty, taux = TMOE.moe_fwd(tcfg, tp,
                                torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    _close(ty.float(), np.asarray(jy, np.float32), 2e-2, "bf16 output")
    _close(taux, jaux, 1e-6, "bf16 aux loss")


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_moe_gradients_match_jax(setting):
    """d(sum(out * w) + aux) for the router and every expert leaf within
    1e-4; recomputing each group in the backward (``remat``) gives the
    same gradients bitwise."""
    jcfg, tcfg = _cfgs(setting)
    jp, tp = _params(jcfg, tcfg, seed=2)
    x = _x(tcfg, seed=3)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p):
        y, aux = JMOE.moe_fwd(jcfg, p, jnp.asarray(x))
        return jnp.sum(y * jnp.asarray(w)) + aux
    jg = jax.grad(jloss)(jp)

    def tgrads(cfg):
        tp.requires_grad_(True)
        y, aux = TMOE.moe_fwd(cfg, tp, torch.from_numpy(x))
        loss = (y * torch.from_numpy(w)).sum() + aux
        named = dict(tp.named_parameters())
        return dict(zip(named, torch.autograd.grad(loss,
                                                   list(named.values()))))
    plain = tgrads(dataclasses.replace(tcfg, remat=False))
    assert plain.keys() == jg.keys() == {"router", "w_in", "w_gate",
                                         "w_out"}
    for k, g in plain.items():
        _close(g, jg[k], 1e-4, f"grad {k}")
    for k, g in tgrads(dataclasses.replace(tcfg, remat=True)).items():
        assert torch.equal(g, plain[k]), k


def test_moe_combine_is_bitwise_repeatable():
    jcfg, tcfg = _cfgs("drops")
    _, tp = _params(jcfg, tcfg)
    x = torch.from_numpy(_x(tcfg))
    with torch.no_grad():
        a, _ = TMOE.moe_fwd(tcfg, tp, x)
        b, _ = TMOE.moe_fwd(tcfg, tp, x)
    assert torch.equal(a, b)
