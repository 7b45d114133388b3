"""The port's contract gate (``repro_torch.analysis``) held to the
reference's (``repro.analysis``) and shown able to fail.

Held against the reference:
  * ``Finding.key`` / ``render()`` and the baseline file: the same on the
    same fields, and a baseline either package writes loads the same in
    the other;
  * the lint's declared mesh axes (each package reading its own
    ``sharding/rules.py``) and the AST helpers on the same sources;
  * ``InvokeStats``: the same field names, every integer leaf int32, and
    on the audit's grid (3 capacity points x 2 margins x 2 residency sets
    x 2 row masks) the port's ``mcma_dispatch`` stats exactly the
    reference's ``mcma_dispatch`` under ``jax.jit`` (``interpret=True``)
    on the same numpy inputs, for each backend;
  * ``activation_moves`` on the case of tests/test_fused_dispatch.py
    (t 128, n 3, d 32, d_h 16, 3 layers): the fused backend runs at most
    one standalone activation gather and scatter a layer, fewer than the
    unfused one, as the reference's jaxpr count says.

Shown able to fail: every form of RL002, RL004 and RL005 on an injected
violation (and the CLI's exit codes on one of them), every audit check
(TA001 on a server that builds a step per tick, TA002 on an int64 leaf,
TA003 on ``.item()`` and on a boolean-mask index) and the op count's
stop at the kernel wrappers.  The tree holds its contracts: the lint and the audit
return nothing the port's baseline does not grandfather.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.analysis import astutil as ref_astutil  # noqa: E402
from repro.analysis import findings as ref_findings  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis.opcount import \
    activation_moves as ref_activation_moves  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.runtime import dispatch as JD  # noqa: E402
from repro_torch.analysis import astutil, audit, findings  # noqa: E402
from repro_torch.analysis.jit_cache import (assert_zero_retrace,  # noqa: E402
                                            cache_size, step_objects)
from repro_torch.analysis.lint import LintContext, lint_paths  # noqa: E402
from repro_torch.analysis.opcount import (GATHER_OPS,  # noqa: E402
                                          activation_moves,
                                          count_dynamic_ops)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import dispatch as D  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parent.parent
BASELINE = REPO / "analysis_baseline_torch.txt"
BACKENDS = ("xla", "pallas", "pallas_fused")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The cases' tensors are tiny: beside other test workers, torch's
    intra-op threads only wait on each other (the audit ran 40x slower
    with them in a parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the findings record and the baseline, against the reference
# ---------------------------------------------------------------------------

FIELDS = [
    dict(rule="RL002", path="src/a.py", line=3, scope="f",
         detail="method:item", message="m"),
    dict(rule="TA003", path="audit:steps", line=0, scope="",
         detail="sync:index[bool]", message="two: colons"),
    dict(rule="RL005", path="src/k/b.py", line=12, scope="g",
         detail="floordiv:t // block_t", message="x"),
]


@pytest.mark.parametrize("fields", FIELDS, ids=lambda f: f["rule"])
def test_finding_key_and_render_match_reference(fields):
    port, ref = findings.Finding(**fields), ref_findings.Finding(**fields)
    assert port.key == ref.key
    assert port.render() == ref.render()


@pytest.mark.parametrize("writer", ("port", "reference"))
def test_baseline_crosses_packages(writer, tmp_path):
    mod = findings if writer == "port" else ref_findings
    rows = [mod.Finding(**f) for f in FIELDS]
    path = tmp_path / "baseline.txt"
    mod.write_baseline(path, rows)
    keys = findings.load_baseline(path)
    assert keys == ref_findings.load_baseline(path) == {r.key for r in rows}
    port_rows = [findings.Finding(**f) for f in FIELDS]
    new, old, stale = findings.split_by_baseline(port_rows[:2], keys)
    assert new == [] and len(old) == 2 and stale == {port_rows[2].key}


def test_declared_axes_match_reference():
    port = LintContext(REPO).declared_axes()
    assert port == ref_lint.LintContext(REPO).declared_axes()
    assert port == {"pod", "data", "model"}


AST_FILES = ("src/repro_torch/runtime/dispatch.py",
             "src/repro_torch/kernels/slstm_scan.py",
             "src/repro/runtime/dispatch.py", "chip_smoke.py")


@pytest.mark.parametrize("rel", AST_FILES)
def test_astutil_matches_reference(rel):
    import ast
    src = (REPO / rel).read_text()
    a, b = ast.parse(src), ast.parse(src)
    assert astutil.collect_aliases(b) == ref_astutil.collect_aliases(a)

    def fns(mod, tree):
        return [(f.name, f.lineno, tuple(s.name for s in stack))
                for f, stack in mod.functions(tree)]
    assert fns(astutil, b) == fns(ref_astutil, a)
    got = [astutil.string_items(n) for n in ast.walk(b)]
    assert got == [ref_astutil.string_items(n) for n in ast.walk(a)]
    assert any(s is not None for s in got)


# ---------------------------------------------------------------------------
# TA002's leaves and the engine's stats on the audit's grid
# ---------------------------------------------------------------------------

def _port_engine(case, backend, exact_cap, invoke_cap, v):
    t = {k: torch.from_numpy(a) for k, a in case.items()}
    stacks = ops.prepad_switched_weights(t["w1"], t["b1"], t["w2"], t["b2"])
    tier, margins, residency, mask = (torch.from_numpy(a) for a in v)
    return D.mcma_dispatch(
        t["x"], t["logits"], lambda xb: F.silu(xb @ t["wi"]) @ t["wo"],
        *stacks, exact_cap=exact_cap, invoke_cap=invoke_cap,
        backend=backend, block_t=audit.BLOCK_T, weights_prepadded=True,
        row_mask=mask, tier=tier, tier_margins=margins,
        residency=residency)[1]


def _ref_engine_fn(case, backend, exact_cap, invoke_cap):
    """The reference's mcma_dispatch under jax.jit, its stats only."""
    j = {k: jnp.asarray(a) for k, a in case.items()}
    stacks = jops.prepad_switched_weights(j["w1"], j["b1"], j["w2"], j["b2"])
    exact_fn = lambda xb: jnp.dot(jax.nn.silu(jnp.dot(xb, j["wi"])),
                                  j["wo"])

    def run(tier, margins, residency, mask):
        return JD.mcma_dispatch(
            j["x"], j["logits"], exact_fn, *stacks, exact_cap=exact_cap,
            invoke_cap=invoke_cap, backend=backend, block_t=audit.BLOCK_T,
            interpret=backend != "xla", weights_prepadded=True,
            row_mask=mask, tier=tier, tier_margins=margins,
            residency=residency)[1]
    return jax.jit(run)


def test_invoke_stats_leaves_match_reference():
    case = audit.engine_case()
    v = audit.variants()[0]
    port = _port_engine(case, "xla", *audit.CAPACITY_LADDER[0], v)
    ref = _ref_engine_fn(case, "xla", *audit.CAPACITY_LADDER[0])(
        *map(jnp.asarray, v))
    assert list(port.keys()) == list(ref.keys())
    port_ints = {k for k, x in port.items()
                 if not (x.dtype.is_floating_point or x.dtype == torch.bool)}
    ref_ints = {k for k, x in ref.items()
                if jnp.issubdtype(x.dtype, jnp.integer)}
    assert port_ints == ref_ints and len(port_ints) == 10
    assert all(port[k].dtype == torch.int32 for k in port_ints)
    assert all(ref[k].dtype == jnp.int32 for k in ref_ints)
    assert audit.stats_dtype_findings(port, scope="s") == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_stats_match_reference_on_the_audit_grid(backend):
    case = audit.engine_case()
    for exact_cap, invoke_cap in audit.CAPACITY_LADDER:
        ref_fn = _ref_engine_fn(case, backend, exact_cap, invoke_cap)
        for i, v in enumerate(audit.variants()):
            port = _port_engine(case, backend, exact_cap, invoke_cap, v)
            ref = ref_fn(*map(jnp.asarray, v))
            for k in port.keys():
                np.testing.assert_array_equal(
                    port[k].numpy(), np.asarray(ref[k]),
                    err_msg=f"{backend} cap=({exact_cap},{invoke_cap}) "
                            f"variant {i}: {k}")


# ---------------------------------------------------------------------------
# activation moves: the fused backend's one pass a layer
# ---------------------------------------------------------------------------

def _moves_case():
    t, n, d, d_h, layers = 128, 3, 32, 16, 3
    rng = np.random.default_rng(9)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    x = f(t, d, sc=0.5)
    w = [f(n, d, d_h, sc=0.2), f(n, d_h, sc=0.1), f(n, d_h, d, sc=0.2),
         f(n, d, sc=0.1)]
    case = dict(x=x, logits=(x @ f(d, n + 1, sc=0.5)).astype(np.float32),
                w=w, wi=f(d, 2 * d, sc=0.1), wo=f(2 * d, d, sc=0.1))
    return case, layers


def _port_moves(case, layers, backend):
    t = lambda a: torch.from_numpy(a)
    wi, wo = t(case["wi"]), t(case["wo"])
    stacked = [[t(a) * (0.8 + 0.1 * i) for a in case["w"]]
               for i in range(layers)]
    plan = D.make_dispatch_plan(t(case["logits"]), exact_cap=64,
                                invoke_cap=48, backend=backend, block_t=32)

    def tick(h):
        for ws in stacked:
            h = D.execute_dispatch(plan, h, lambda xb: F.silu(xb @ wi) @ wo,
                                   *ws)
        return h
    return activation_moves(tick, (t(case["x"]),))


def _ref_moves(case, layers, backend):
    j = lambda a: jnp.asarray(a)
    wi, wo = j(case["wi"]), j(case["wo"])
    stacked = [jnp.stack([j(a) * (0.8 + 0.1 * i) for i in range(layers)])
               for a in case["w"]]
    plan = JD.make_dispatch_plan(j(case["logits"]), exact_cap=64,
                                 invoke_cap=48, backend=backend, block_t=32)
    interp = backend in JD.PALLAS_BACKENDS

    def tick(xx):
        def layer(h, ws):
            return JD.execute_dispatch(
                plan, h, lambda xb: jnp.dot(jax.nn.silu(jnp.dot(xb, wi)),
                                            wo),
                *ws, interpret=interp), None
        return jax.lax.scan(layer, xx, tuple(stacked))[0]
    return ref_activation_moves(jax.make_jaxpr(tick)(j(case["x"])))


def test_fused_execute_runs_one_activation_pass_per_layer():
    case, layers = _moves_case()
    moves, ref = {}, {}
    for be in BACKENDS:
        g, s = _port_moves(case, layers, be)
        assert g % layers == 0 and s % layers == 0, (be, g, s)
        moves[be] = (g // layers, s // layers)
        rg, rs = _ref_moves(case, layers, be)
        ref[be] = (rg // layers, rs // layers)
    print(f"activation moves a layer (gathers, scatters): port {moves}, "
          f"reference {ref}")
    gf, sf = moves["pallas_fused"]
    gu, su = moves["pallas"]
    assert gf <= 1 and sf <= 1, moves
    assert gf < gu and sf < su, moves
    assert moves == ref


def test_opcount_stops_at_the_kernel_wrappers():
    """On the CPU a wrapper runs its PyTorch twin, whose w1[c] (and b1,
    w2, b2) gather is the kernel's own weight load: counted only with the
    suspension removed."""
    rng = np.random.default_rng(3)
    n, d, dh, t = 3, 32, 16, 40
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    cls = torch.from_numpy(rng.integers(0, n, t).astype(np.int32))
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((n, d, dh), (n, dh), (n, dh, d), (n, d))]

    def run(xv):
        return ops.switched_apply(xv, cls, *w, block_t=16)
    stopped = count_dynamic_ops(run, (x,), GATHER_OPS, min_operand_rank=2)
    entered = count_dynamic_ops(run, (x,), GATHER_OPS, min_operand_rank=2,
                                enter_kernels=True)
    assert entered == stopped + 4, (stopped, entered)
    from repro_torch.kernels import switched_mlp
    assert switched_mlp.switched_mlp.__name__ == "switched_mlp"


def test_opcount_keeps_the_wrappers_launch_counts():
    """A wrapper counts a launch on its module's name for it, which is
    the suspending shim during a count: the count comes back on exit."""
    from repro_torch.analysis.opcount import _counter, kernels_opaque
    from repro_torch.kernels import slstm_scan, switched_mlp
    real = switched_mlp.switched_mlp
    before = real.launches, slstm_scan.slstm_scan.launches
    with kernels_opaque(_counter({}, 0)):
        assert switched_mlp.switched_mlp is not real
        switched_mlp.switched_mlp.launches += 2     # as the wrapper does
        slstm_scan.slstm_scan.launches += 1
    assert switched_mlp.switched_mlp is real
    assert (real.launches, slstm_scan.slstm_scan.launches) == (
        before[0] + 2, before[1] + 1)
    real.launches, slstm_scan.slstm_scan.launches = before


# ---------------------------------------------------------------------------
# every lint rule can fail; the guarded forms stay clean
# ---------------------------------------------------------------------------

SPEC = """
    class P(tuple):
        pass

    def dp_axes(mesh):
        return ("data",)

    def param_spec(mesh):
        return P("model", None)
    """

COLLECTIVES = """
    def all_reduce_sum(t, axes, mesh=None):
        return t

    def all_gather(t, axes, dim=0, mesh=None):
        return t

    def gather_whole(t, spec, mesh=None):
        return t
    """

# (rule, relpath, source, detail prefix)
VIOLATIONS = {
    "RL002-item": ("RL002", "src/repro_torch/models/bad.py", """
        import torch

        def f(x: torch.Tensor):
            return x.sum().item()
        """, "method:item"),
    "RL002-cpu": ("RL002", "src/repro_torch/runtime/steps.py", """
        def f(x):
            return x.cpu()
        """, "method:cpu"),
    "RL002-int": ("RL002", "src/repro_torch/kernels/bad.py", """
        import torch

        def f(t: torch.Tensor):
            return int(t)
        """, "cast:int:t"),
    "RL002-synchronize": ("RL002", "src/repro_torch/runtime/dispatch.py", """
        import torch

        def f(x):
            torch.cuda.synchronize()
            return x
        """, "call:torch.cuda.synchronize"),
    "RL004-axis": ("RL004", "src/repro_torch/models/bad.py", """
        from repro_torch.sharding import collectives as C

        def f(x):
            return C.all_reduce_sum(x, "modle")
        """, "axis:modle"),
    "RL005-grid": ("RL005", "src/repro_torch/kernels/bad.py", """
        def grid_for(t, block_t):
            return (t // block_t,)
        """, "floordiv:t // block_t"),
    "RL005-page": ("RL005", "src/repro_torch/runtime/pager.py", """
        def table_shape(max_len, page_size):
            return max_len // page_size
        """, "floordiv:max_len // page_size"),
    "RL005-launch": ("RL005", "src/repro_torch/kernels/bad.py", """
        from repro_torch.kernels import build

        def launch(x):
            lib = build.load("switched_mlp", {})
            return getattr(lib, "switched_mlp_f32")(x.data_ptr())
        """, "unchecked-launch:lib"),
}

GOOD = """
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.switched_mlp import check_cuda_args
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import P

    def tiles(t, block_t):
        assert t % block_t == 0
        return t // block_t

    def tiles_up(t, block_t):
        return (t + block_t - 1) // block_t

    def tiles_neg(t, block_t):
        return -(-t // block_t)

    def page_of(pos, page_size):
        return pos // page_size, pos % page_size

    def rows(x: torch.Tensor):
        return int(x.shape[0]) + x.numel()

    def reduce(x, stats_axes):
        ax = tuple(stats_axes)
        return C.all_reduce_sum(x, ax)

    def reduce_declared(x, w):
        y = C.all_gather(x, ("data",), 0)
        return C.gather_whole(w, P("model", None)), y

    def launch(x):
        sfx = check_cuda_args(x, (), (), block_t=16, name="k")
        lib = build.load("switched_mlp", {})
        return getattr(lib, f"switched_mlp_{sfx}")(x.data_ptr())
    """


def _mk_tree(root: Path, sources: dict) -> Path:
    """A fake repo root with the port's spec layer (declaring "data" and
    "model"), its collectives and the given {relpath: source} files."""
    base = {"src/repro_torch/sharding/rules.py": SPEC,
            "src/repro_torch/sharding/collectives.py": COLLECTIVES}
    for rel, src in {**base, **sources}.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def _cli(root: Path, *extra: str):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--stage", "lint",
         "--root", str(root), str(root / "src"), *extra],
        capture_output=True, text=True, timeout=120, env=env)


@pytest.mark.parametrize("case", sorted(VIOLATIONS))
def test_injected_violation_is_caught(case, tmp_path):
    rule, rel, src, detail = VIOLATIONS[case]
    root = _mk_tree(tmp_path, {rel: src})
    fs = [f for f in lint_paths([root / "src"], root) if f.rule == rule]
    assert [f.detail for f in fs] == [detail], fs


def test_guarded_forms_stay_clean(tmp_path):
    root = _mk_tree(tmp_path, {"src/repro_torch/kernels/good.py": GOOD,
                               "src/repro_torch/models/good.py": GOOD})
    assert lint_paths([root / "src"], root) == []


def test_current_tree_is_clean():
    """The port's own files carry no finding its baseline does not
    grandfather (the CLI's lint stage over the default paths exits 0),
    and the lint stage imports no torch."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from repro_torch.analysis.__main__ import main\n"
         "rc = main(['--stage', 'lint', '--root', sys.argv[1]])\n"
         "assert 'torch' not in sys.modules\n"
         "sys.exit(rc)", str(REPO)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK: no new findings" in r.stdout, r.stdout


def test_cli_fails_on_new_finding_and_baseline_suppresses(tmp_path):
    rule, rel, src, _ = VIOLATIONS["RL002-item"]
    root = _mk_tree(tmp_path, {rel: src})
    r = _cli(root)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "RL002" in r.stdout
    # grandfathered, the same tree passes...
    assert _cli(root, "--update-baseline").returncode == 0
    r = _cli(root)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "grandfathered" in r.stdout
    # ...a NEW violation still fails...
    _mk_tree(root, {"src/repro_torch/kernels/worse.py":
                    VIOLATIONS["RL005-grid"][2]})
    r = _cli(root)
    assert r.returncode == 1 and "RL005" in r.stdout, r.stdout
    # ...and a fixed one is stale, not a failure
    (root / "src/repro_torch/kernels/worse.py").unlink()
    (root / rel).write_text("x = 1\n")
    r = _cli(root)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[stale]" in r.stdout


# ---------------------------------------------------------------------------
# every audit check can fail
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_params():
    from repro_torch.models import model as M
    return M.init_model(0, audit.smoke_serve_cfg(), device="cpu")


def _stream(server_cls, params):
    from repro_torch.runtime.options import LibrarySpec, ServeOptions
    from repro_torch.runtime.server import Request
    cfg = audit.smoke_serve_cfg("pallas")
    srv = server_cls(cfg, params, options=ServeOptions(
        **audit.SERVER_OPTIONS, backend="pallas",
        library=LibrarySpec(6, 2, observe_window=2, cooldown=2)))
    rng = np.random.default_rng(1)
    for i, n in enumerate(audit.SERVER_PROMPTS):
        srv.submit(Request(rid=i, prompt=rng.integers(1, cfg.vocab, n)
                           .astype(np.int32), max_new=6, tier=i % 3))
    srv.run_until_drained(max_ticks=400)
    return srv


def test_ta001_server_building_a_step_per_tick(smoke_params):
    from repro_torch.runtime.server import DecodeServer

    class PerTick(DecodeServer):
        """Caches its decode steps by tick instead of by rung."""

        def _active_step(self):
            self._steps[self.ticks] = self._make_step(
                self.controller.ladder[self.controller.index])
            return self._steps[self.ticks]

    good = _stream(DecodeServer, smoke_params)
    visited = audit.rungs_visited(good.controller.summary())
    assert len(visited) >= 2
    assert step_objects(good)["decode"] == len(visited)
    assert cache_size(good) == len(visited)
    assert audit.audit_server(good, scope="good") == []
    bad = _stream(PerTick, smoke_params)
    fs = audit.audit_server(bad, scope="per-tick")
    assert [f.rule for f in fs] == ["TA001"], fs
    with pytest.raises(AssertionError, match="a rung change forced"):
        assert_zero_retrace(bad, "a rung change",
                            expected=len(visited))


def test_assert_zero_retrace_on_compiled_and_eager_callables():
    def f(x):
        return x * 2

    compiled = torch.compile(f, backend="eager", dynamic=False)
    compiled(torch.zeros(3))
    compiled(torch.ones(3))
    assert cache_size(compiled) == 1
    assert_zero_retrace(compiled, "a value change")
    compiled(torch.zeros(5))
    assert cache_size(compiled) == 2
    with pytest.raises(AssertionError, match="a shape change forced"):
        assert_zero_retrace(compiled, "a shape change")
    assert cache_size(f) is None
    assert_zero_retrace(f, "an eager callable")


def test_ta002_int64_leaf_is_caught():
    case = audit.engine_case()
    stats = _port_engine(case, "pallas", *audit.CAPACITY_LADDER[1],
                         audit.variants()[0])
    assert audit.stats_dtype_findings(stats, scope="s") == []
    bad = dataclasses.replace(stats, tier_counts=stats.tier_counts.long())
    fs = audit.stats_dtype_findings(bad, scope="s")
    assert [f.detail for f in fs] == ["stats-dtype:['tier_counts']"], fs
    assert fs[0].rule == "TA002"


def test_ta003_item_and_mask_index_are_caught(smoke_params):
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as steps_lib
    cfg = audit.smoke_serve_cfg("pallas")
    step = steps_lib.make_decode_step(cfg, use_mcma_dispatch=True,
                                      with_stats=True)
    toks, _, _, tier, masks, margins, res = audit.step_inputs(4, "cpu")

    def args():
        return (smoke_params, M.init_cache(cfg, 4, 32, device="cpu"), toks,
                masks[1], tier, margins[0], res[0])

    def with_item(*a):
        out = step(*a)
        return out, out[0].sum().item()

    def with_mask(*a):
        logits, cache, m = step(*a)
        return logits[a[3]], cache, m

    assert audit.callback_findings(step, args(), scope="step") == []
    fs = audit.callback_findings(with_item, args(), scope="item")
    assert [(f.rule, f.detail) for f in fs] == [
        ("TA003", "sync:_local_scalar_dense")], fs
    fs = audit.callback_findings(with_mask, args(), scope="mask")
    assert [(f.rule, f.detail) for f in fs] == [
        ("TA003", "sync:index[bool]")], fs


# ---------------------------------------------------------------------------
# the tree holds its contracts
# ---------------------------------------------------------------------------

def test_run_audit_is_clean():
    """Every backend, the engine and the steps (dense and paged, layer and
    tick scope) and the autotune server; the sharded engine is audited in
    tests/test_torch_sharded_dispatch.py's world."""
    fs = audit.run_audit(backends=BACKENDS, with_steps=True, sharded=False)
    new, _, _ = findings.split_by_baseline(
        fs, findings.load_baseline(BASELINE))
    assert new == [], "\n".join(f.render() for f in new)
