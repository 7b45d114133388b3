"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``), on shapes alone.

For every architecture of the registry at its full widths, the port's
``param_pspecs`` (walking a ``device="meta"`` model's parameters) give
the reference's specs with the stacked scan dims' leading ``None``s
dropped, and the same ``ShardingReport.fallbacks``; ``cache_pspecs`` give
the reference's specs on the dense cache (batch 1, where the sequence
shards, and batch 32) and on the paged cache.  Also ``batch_pspec`` and
the four spec builders of the serving paths.  The meshes are the
reference tests' duck-typed ``FakeMesh`` shapes: (16, 16), (2, 16, 16),
(4, 2) and (16, 24).  Nothing is allocated: the reference's trees come
from ``jax.eval_shape``, the port's from the meta device.
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import dispatch as D  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


class FakeMesh:
    """Duck-typed mesh: just axis names and sizes for the rules."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = [FakeMesh((16, 16), ("data", "model")),
          FakeMesh((2, 16, 16), ("pod", "data", "model")),
          FakeMesh((4, 2), ("data", "model")),
          FakeMesh((16, 24), ("data", "model"))]


def _cfgs(arch):
    """The arch with the ApproxFFN on (a dense arch's serving layout, the
    approximator and tick-router rules), in both packages."""
    jc, pc = jget_config(arch), get_config(arch)
    on = lambda c: dataclasses.replace(c, approx=dataclasses.replace(
        c.approx, enable=True))
    return on(jc), on(pc)


def _plain(spec):
    """A spec of either package as a plain tuple."""
    return tuple(spec)


def _ref_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _ref_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(arch):
    jc, pc = _cfgs(arch)
    shapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), jc))
    ref_shape = dict(_ref_leaves(shapes))
    model = M.Model(pc, "meta")
    port_shape = {k: tuple(v.shape) for k, v in model.named_parameters()}
    # every port parameter is a per-layer slice of one reference leaf
    by_path = {}
    for name, shp in port_shape.items():
        path = R._ref_path(name)
        assert path in ref_shape, (name, path)
        lead = len(ref_shape[path].shape) - len(shp)
        assert ref_shape[path].shape[lead:] == shp, (name, shp)
        by_path.setdefault(path, []).append(name)
    assert set(by_path) == set(ref_shape)
    for mesh in MESHES:
        jspecs, jrep = JR.param_pspecs(mesh, shapes)
        jflat = dict(_ref_leaves(jspecs))
        specs, rep = R.param_pspecs(mesh, model)
        assert rep.fallbacks == jrep.fallbacks, mesh.devices.shape
        for name, shp in port_shape.items():
            js = _plain(jflat[R._ref_path(name)])
            lead = len(js) - len(shp) if js else 0
            assert all(s is None for s in js[:lead]), (name, js)
            assert _plain(specs[name]) == js[lead:], (name, mesh.devices.shape)


def _caches(arch, batch):
    """(reference cache shapes, port cache on meta) pairs: the dense cache,
    and the paged one where the family takes pages."""
    jc, pc = _cfgs(arch)
    out = [(jax.eval_shape(lambda: JM.init_cache(jc, batch, 256)),
            M.init_cache(pc, batch, 256, device="meta"))]
    if M.topology(pc).kind == "uniform" and not pc.sliding_window:
        out.append((jax.eval_shape(lambda: JM.init_cache(
            jc, batch, 256, page_size=16, kv_pages=64)),
            M.init_cache(pc, batch, 256, page_size=16, kv_pages=64,
                         device="meta")))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_reference(arch):
    for batch in (1, 32):
        for jcache, cache in _caches(arch, batch):
            jpaths = dict(_ref_leaves(jcache))
            ppaths = dict(R._leaves(cache))
            assert set(jpaths) == set(ppaths)
            for mesh in MESHES:
                jspecs = dict(_ref_leaves(JR.cache_pspecs(mesh, jcache)))
                specs = dict(R._leaves(R.cache_pspecs(mesh, cache)))
                assert {k: _plain(v) for k, v in specs.items()} == \
                    {k: _plain(v) for k, v in jspecs.items()}, \
                    (batch, mesh.devices.shape)


def test_state_pspecs_cover_every_leaf():
    """The train state's moments shard like their parameters."""
    mesh = MESHES[0]
    model = M.Model(_cfgs("olmo-1b")[1], "meta")
    names = [k for k, _ in model.named_parameters()]
    state = {"params": model, "opt": {"m": {}, "v": {}}, "step": None}
    specs, _ = R.state_pspecs(mesh, state)
    assert set(specs["params"]) == set(names)
    assert specs["opt"]["m"] == specs["opt"]["v"] == specs["params"]
    assert specs["step"] == R.P()


@pytest.mark.parametrize("shape", [(1, 524288), (32, 128), (32, 128, 64),
                                   (3, 48, 64), (2, 5)])
def test_batch_pspec_matches_reference(shape):
    for mesh in MESHES:
        arr = jax.ShapeDtypeStruct(shape, jax.numpy.int32)
        assert _plain(R.batch_pspec(mesh, shape)) == \
            _plain(JR.batch_pspec(mesh, arr)), (shape, mesh.devices.shape)


def _tree(x):
    """Specs nested in dicts, tuples and DispatchPlans, as plain values."""
    if isinstance(x, (JD.DispatchPlan, D.DispatchPlan)):
        return {f.name: _tree(getattr(x, f.name))
                for f in dataclasses.fields(D.DispatchPlan)}
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (R.P, jax.sharding.PartitionSpec)):
        return ("P",) + _plain(x)
    if isinstance(x, tuple):
        return tuple(_tree(v) for v in x)
    return x


def test_spec_builders_match_reference():
    plan = types.SimpleNamespace(n_approx=3, exact_cap=8, invoke_cap=(4, 2, 3),
                                 block_t=16, backend="pallas", n_tiers=3,
                                 library_size=6)
    for mesh in MESHES:
        for flags in ({}, {"with_mask": True}, {"with_tier": True},
                      {"with_residency": True},
                      {"with_mask": True, "with_tier": True,
                       "with_residency": True}):
            assert _tree(R.mcma_dispatch_specs(mesh, **flags)) == \
                _tree(JR.mcma_dispatch_specs(mesh, **flags))
        assert _tree(R.mcma_dispatch_specs(mesh, data_axes=("data",))) == \
            _tree(JR.mcma_dispatch_specs(mesh, data_axes=("data",)))
        assert _tree(R.dispatch_plan_specs(mesh, plan)) == \
            _tree(JR.dispatch_plan_specs(mesh, plan))
        meta = dict(n_approx=2, exact_cap=4, invoke_cap=3, block_t=8,
                    backend="xla", n_tiers=1, library_size=0)
        assert _tree(R.dispatch_plan_specs(mesh, **meta)) == \
            _tree(JR.dispatch_plan_specs(mesh, **meta))
        for gated in (False, True):
            assert _tree(R.approx_serve_specs(mesh, gated=gated, plan=plan)) \
                == _tree(JR.approx_serve_specs(mesh, gated=gated, plan=plan))
            for flags in ({}, {"with_tier": True, "mask2d": True},
                          {"with_residency": True}):
                assert _tree(R.approx_serve_specs(mesh, gated=gated,
                                                  **flags)) == \
                    _tree(JR.approx_serve_specs(mesh, gated=gated, **flags))
            assert _tree(R.moe_manual_specs(mesh, gated=gated)) == \
                _tree(JR.moe_manual_specs(mesh, gated=gated))
        assert R.dp_axes(mesh) == JR.dp_axes(mesh)
    for t, f, s in ((7, 0.5, 1.0), (64, 0.4, 1.25), (3, 0.01, 1.0),
                    (16, 2.0, 1.0)):
        assert R.shard_capacity(t, f, slack=s) == \
            JR.shard_capacity(t, f, slack=s)


def test_partition_spec_normalizes_one_tuples():
    assert R.P(("data",), None) == R.P("data", None) == ("data", None)
    assert R.P(("pod", "data"), "model")[0] == ("pod", "data")
    assert R.P() != R.P(None)
