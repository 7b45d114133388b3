"""``repro_torch.optim.compression`` against ``repro.optim.compression``
with no processes: the reference's ``ef_int8_allreduce_tree`` run under
``jax.vmap(..., axis_name="pod")`` over a leading axis of 4 (its
all-gather works under vmap), against the port's per-rank arithmetic
(``_encode`` on each rank's leaf, ``_decode_mean`` on the gathered
parts): q exactly, the scale and the new residual within 1e-7 relative,
the mean within 1e-6.  The collective path itself, on a ("pod",) mesh of
4 ranks, is held by tests/test_torch_train_mesh.py."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import compression as JC  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PODS = 4
SHAPES = {"vec": (37,), "mat": (5, 3), "big": (64, 48)}


def _inputs(seed, scale_e=1e-2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal((PODS, *s)) * 10 ** rng.uniform(-3, 1))
         .astype(dtype) for k, s in SHAPES.items()}
    e = {k: (rng.standard_normal((PODS, *s)) * scale_e).astype(np.float32)
         for k, s in SHAPES.items()}
    return g, e


def _reference(g, e):
    """(mean, new_err, q, scale) per pod, from the reference under vmap."""
    def one(gs, es):
        mean, new = JC.ef_int8_allreduce_tree(gs, es, "pod")
        qs = {k: JC._quantize(gs[k].astype(jnp.float32) + es[k])
              for k in gs}
        return mean, new, {k: v[0] for k, v in qs.items()}, \
            {k: v[1] for k, v in qs.items()}
    return jax.tree.map(np.asarray, jax.vmap(one, axis_name="pod")(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_rank_arithmetic_matches_reference_under_vmap(seed):
    g, e = _inputs(seed)
    jmean, jerr, jq, jscale = _reference(g, e)
    for k in SHAPES:
        enc = [TC._encode(torch.from_numpy(g[k][r]), torch.from_numpy(e[k][r]))
               for r in range(PODS)]
        q = torch.stack([x[0] for x in enc])
        scales = torch.stack([x[1] for x in enc])
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), jq[k], err_msg=k)
        np.testing.assert_allclose(scales.numpy(), jscale[k], rtol=1e-7,
                                   err_msg=k)
        for r, (_, _, new_e) in enumerate(enc):
            np.testing.assert_allclose(new_e.numpy(), jerr[k][r], rtol=1e-7,
                                       atol=1e-7 * float(jscale[k][r]),
                                       err_msg=k)
        mean = TC._decode_mean(q, scales, torch.from_numpy(g[k][0]))
        for r in range(PODS):          # every pod holds the same mean
            np.testing.assert_allclose(mean.numpy(), jmean[k][r], rtol=1e-6,
                                       atol=1e-6 * float(jscale[k].max()),
                                       err_msg=k)


def test_zero_gradient_and_residual_stay_zero():
    """An all-zero leaf quantizes to 0 at scale 1e-12 and leaves no
    residual, as in the reference."""
    q, scale, new_e = TC._encode(torch.zeros(6), torch.zeros(6))
    jq, jscale = JC._quantize(jnp.zeros(6))
    assert not q.any() and not new_e.any()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale) == pytest.approx(1e-12)


def test_bfloat16_gradients_keep_their_dtype():
    g, e = _inputs(3)
    enc = [TC._encode(torch.from_numpy(g["mat"][r]).to(torch.bfloat16),
                      torch.from_numpy(e["mat"][r])) for r in range(PODS)]
    like = torch.zeros(SHAPES["mat"], dtype=torch.bfloat16)
    mean = TC._decode_mean(torch.stack([x[0] for x in enc]),
                           torch.stack([x[1] for x in enc]), like)
    assert mean.dtype == torch.bfloat16
    assert all(x[2].dtype == torch.float32 for x in enc)


def test_init_error_feedback_is_float32_zeros():
    params = {"a": torch.ones(3, dtype=torch.bfloat16),
              "b": {"c": torch.ones(2, 2)}}
    err = TC.init_error_feedback(params)
    assert err["a"].dtype == err["b"]["c"].dtype == torch.float32
    assert not err["a"].any() and err["b"]["c"].shape == (2, 2)
