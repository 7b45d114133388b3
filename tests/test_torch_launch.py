"""The port's dry run (``launch/{dryrun,hlo_cost,roofline}`` and the
registry helpers only it uses) against the reference, on the CPU at one
torch thread; every process group in a process of its own.

Held:
  * ``SHAPES``, ``cells`` and ``full_attention_only`` equal to the
    reference's for all 10 archs; ``input_specs``' shapes and dtypes
    equal to the reference's (``jax.eval_shape``) for every arch and
    cell, cache leaves matched by name;
  * ``n_params``, ``n_active`` and ``model_flops`` equal to the
    reference's formula over its ``jax.eval_shape(init_model)`` leaves;
  * ``analyze``'s FLOPs equal to ``FlopCounterMode``'s on a smoke
    forward (its attention counted, the loop traced by the counter);
  * each kernel op's record equal to ``kernels/work``'s count at its
    operands, the same on fake and real tensors;
  * the attention count equal to the traced ``flash_attention``, forward
    and backward, at several block counts, causal and sliding window;
  * the smoke internlm2 cells on a fake (2, 2) world, and its decode on
    a model axis of 4 (2 kv heads: the head_dim-split cache), recording
    the FLOPs, collective counts and wire bytes per kind (the port's and
    the ring model's) that the same steps record in a real 4-rank gloo
    world (tests/_torch_mesh_world.py);
  * the smoke xLSTM on a model axis of 3 (4 heads) written as
    ``"ok": false`` with ``check_mesh_servable``'s message;
  * ``roofline_terms`` on a fixed cell with the H100 constants;
    ``load_cells`` and ``fmt_table`` on a cell that is ok and one that is
    refused.
Nothing is held bitwise across the two packages.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import _torch_mesh_world as W  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import base as B  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.kernels import ops, work  # noqa: E402
from repro_torch.launch import dryrun, hlo_cost, roofline  # noqa: E402
from repro_torch.launch.mesh import MeshShape, spawn_world  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The small cells recorded on a fake (2, 2) world (a subprocess)
    and in a real 4-rank gloo world, started together."""
    out = str(tmp_path_factory.mktemp("dryrun_worlds"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), HERE]))
    fake = subprocess.Popen(
        [sys.executable, "-c", "import _torch_mesh_world as W; "
         f"W.dryrun_fake({out + '/dryrun_fake.json'!r})"], env=env)
    try:
        spawn_world(W.dryrun_rank, 4, (out,), init_method=f"file://{out}/rdv")
    finally:
        assert fake.wait(timeout=300) == 0
    with open(f"{out}/dryrun_fake.json") as f, \
            open(f"{out}/dryrun_gloo.json") as g:
        return json.load(f), json.load(g)


# ---------------------------------------------------------------------------
# the registry helpers
# ---------------------------------------------------------------------------

def test_shapes_cells_and_full_attention_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in B.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(B.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(JB.ShapeConfig)]
    assert R.ARCH_IDS == JR.ARCH_IDS
    for arch in R.ARCH_IDS:
        assert R.full_attention_only(R.get_config(arch)) == \
            JR.full_attention_only(JR.get_config(arch)), arch
        assert [dataclasses.asdict(s) for s in R.cells(arch)] == \
            [dataclasses.asdict(s) for s in JR.cells(arch)], arch


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = R.get_config(arch), JR.get_config(arch)
    for shape in R.cells(arch):
        want = dict(_leaves(JR.input_specs(jcfg, JB.SHAPES[shape.name])))
        with FakeTensorMode():
            got = dict(_leaves(R.input_specs(cfg, shape, device="cpu")))
        assert sorted(got) == sorted(want), (arch, shape.name)
        for name, t in got.items():
            assert tuple(t.shape) == tuple(want[name].shape), (
                arch, shape.name, name)
            assert str(t.dtype).removeprefix("torch.") == \
                str(want[name].dtype), (arch, shape.name, name)


@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_model_numbers_equal_the_reference_formula(arch):
    """The reference's ``run_cell`` counts (dryrun.py:117-126) over its
    ``jax.eval_shape(init_model)`` leaves, for every cell."""
    jcfg = JR.get_config(arch)
    shapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    n_params = sum(int(leaf.size) for leaf in jax.tree_util.tree_leaves(shapes))
    if jcfg.moe.n_experts:
        dense_ffn = jcfg.n_layers * (3 if jcfg.gated_ffn else 2) \
            * jcfg.d_model * jcfg.d_ff
        n_active = n_params - (jcfg.moe.n_experts - jcfg.moe.top_k) \
            * dense_ffn
    else:
        n_active = n_params
    for shape in R.cells(arch):
        mult = {"train": 6 * shape.global_batch * shape.seq_len,
                "prefill": 2 * shape.global_batch * shape.seq_len,
                "decode": 2 * shape.global_batch}[shape.kind]
        assert dryrun.model_numbers(R.get_config(arch), shape) == {
            "n_params": n_params, "n_active": n_active,
            "model_flops": float(mult) * n_active}, (arch, shape.name)


# ---------------------------------------------------------------------------
# hlo_cost: FLOPs, kernel ops, attention
# ---------------------------------------------------------------------------

def _smoke(arch="internlm2-1.8b", **over):
    return dataclasses.replace(R.smoke_config(R.get_config(arch)), **over)


def test_analyze_flops_equal_the_flop_counter_on_a_smoke_forward():
    """A forward of 256 tokens (8 attention blocks of 32: the count's
    polynomial, not a recorded size) on fake tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = _smoke()
    with FakeTensorMode():
        params = M.init_model(None, cfg, device="cpu")
        toks = torch.zeros((2, 256), dtype=torch.int32)
        with FlopCounterMode(display=False) as fc:
            M.forward(cfg, params, toks)
        cost = hlo_cost.analyze(M.forward, (cfg, params, toks))
    assert cost.flops == fc.get_total_flops() > 0
    assert cost.attention["forward_calls"] == cfg.n_layers
    assert cost.bytes > 0 and cost.n_ops > 0 and cost.n_while == 0


def _switch_operands(rng, t=40, n=4, d=64, dh=32):
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    cls = torch.from_numpy(rng.integers(0, n, t).astype(np.int32))
    w = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((n, d, dh), (n, dh), (n, dh, d), (n, d))]
    return x, cls, w


def _kernel_records(fn, fake: bool):
    if not fake:
        return hlo_cost.analyze(fn).kernels
    with FakeTensorMode(allow_non_fake_inputs=True):
        return hlo_cost.analyze(fn).kernels


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_kernel_ops_record_the_shared_work_count(fake):
    """Each wrapper is one op with ``kernels/work``'s count at the
    operands it is given (every class of the stack); on real tensors the
    wrapper still runs (its result is the twin's)."""
    rng = np.random.default_rng(0)
    x, cls, w = _switch_operands(rng)
    blk = 16
    xp, rows, tile_cls, wk, _, _ = ops.kernel_operands(x, cls, *w,
                                                       block_t=blk)
    n, d_in_p, d_h_p = wk[0].shape
    d_out_p = wk[2].shape[2]
    want = {
        "switched_mlp": work.switch_work(
            xp.shape[0], d_in_p, d_h_p, d_out_p, n_classes=n, itemsize=4,
            index_bytes=4 * tile_cls.numel()),
        "switched_mlp_fused": work.switch_work(
            x.shape[0], x.shape[1], d_h_p, d_out_p, n_classes=n, itemsize=4,
            index_bytes=4 * (rows.numel() + tile_cls.numel())),
    }
    for name, fn in (("switched_mlp", ops.switched_apply),
                     ("switched_mlp_fused", ops.switched_apply_fused)):
        rec = _kernel_records(lambda: fn(x, cls, *w, block_t=blk), fake)
        assert rec == {name: {"calls": 1, "bytes": want[name][0],
                              "flops": want[name][1]}}, name
        xk = xp if name == "switched_mlp" else x     # the rows it maps
        assert want[name][1] == 2 * xk.shape[0] \
            * (xk.shape[1] * d_h_p + d_h_p * d_out_p)
    y = ops.mlp_apply(x, w[0][0], w[1][0], w[2][0], w[3][0], block_t=blk)
    rec = _kernel_records(lambda: ops.mlp_apply(
        x, w[0][0], w[1][0], w[2][0], w[3][0], block_t=blk), fake)
    mlp = work.switch_work(48, 128, 128, 128, n_classes=1, itemsize=4)
    assert rec == {"mlp_forward": {"calls": 1, "bytes": mlp[0],
                                   "flops": mlp[1]}}
    assert y.shape == x.shape
    from repro_torch.kernels import slstm_scan
    s, b, h, hd = 5, 3, 2, 8
    xg = torch.zeros((s, b, h, 4 * hd))
    wh = torch.zeros((h, hd, 4 * hd), dtype=torch.bfloat16)
    st = [torch.zeros((b, h, hd)) for _ in range(4)]
    rec = _kernel_records(lambda: slstm_scan.slstm_scan(xg, wh, *st), fake)
    sw = work.slstm_work(s, b, h, hd, wh_itemsize=2)
    assert sw == ((s * b * h * 4 * hd + s * b * h * hd + 8 * b * h * hd) * 4
                  + h * hd * 4 * hd * 2, 2 * s * b * h * hd * 4 * hd)
    assert rec == {"slstm_scan": {"calls": 1, "bytes": sw[0],
                                  "flops": sw[1]}}


def _flash_costs(cfg, n, grads, counted: bool):
    """(forward, backward) (FLOPs, bytes, ops) of ``flash_attention``
    over n blocks of (2, 4, 8) heads, counted or recorded op by op."""
    real = layers.flash_attention
    with FakeTensorMode():
        qkv = [torch.empty((2, n * cfg.q_block, 4, 8), dtype=cfg.adtype,
                           requires_grad=g) for g in grads]
        with hlo_cost.record(args=qkv) as rec:
            if not counted:
                layers.flash_attention = real
            out = layers.flash_attention(cfg, *qkv)
            fwd = (rec.cost.flops, rec.cost.bytes, rec.cost.n_ops)
            if any(grads):
                g = torch.empty_like(out)
                torch.autograd.grad(out, [t for t in qkv if t.requires_grad],
                                    g)
        c = rec.cost
        return fwd, (c.flops - fwd[0], c.bytes - fwd[1], c.n_ops - fwd[2])


@pytest.mark.parametrize("window,n,grads", [
    (0, 7, (True, True, True)), (0, 3, (True, False, True)),
    (24, 8, (False, False, False)), (24, 2, (True, True, True))],
    ids=["causal-7-grad", "causal-3-grad-qv", "window-8", "window-2-grad"])
def test_attention_count_equals_the_traced_loop(window, n, grads):
    cfg = dataclasses.replace(R.get_config("olmo-1b"), q_block=16,
                              kv_block=16, sliding_window=window)
    counted = _flash_costs(cfg, n, grads, True)
    assert counted == _flash_costs(cfg, n, grads, False)
    assert counted[0][0] == 2 * 2 * 4 * n * n * 16 * 16 * 8 * 2
    if grads == (True, True, True):
        assert counted[1][0] == 2 * counted[0][0]


# ---------------------------------------------------------------------------
# dryrun: the fake world against a gloo world, refusals, the roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(W.DRYRUN_SHAPES))
def test_fake_world_records_what_a_gloo_world_records(worlds, case):
    fake, gloo = worlds[0][case], worlds[1][case]
    kind = W.DRYRUN_SHAPES[case][0]
    assert fake["ok"] and gloo["ok"], (fake.get("error"), gloo.get("error"))
    assert fake["cost"]["flops_per_chip"] == gloo["cost"]["flops_per_chip"]
    for key in ("counts", "by_kind", "ring_by_kind", "wire_bytes_per_chip",
                "internode_bytes_per_chip"):
        assert fake["collectives"][key] == gloo["collectives"][key], key
    assert fake["kernels"] == gloo["kernels"]
    assert fake["attention"] == gloo["attention"]
    assert fake["memory"]["argument_bytes"] == \
        gloo["memory"]["argument_bytes"]
    counts = fake["collectives"]["counts"]
    assert counts.get("all_reduce", 0) > 0 and counts.get("all_gather", 0) > 0
    if kind == "train":
        assert counts["reduce_scatter"] > 0
        assert fake["attention"]["backward_calls"] > 0
    if kind == "decode":      # one weight-switch launch a layer
        assert fake["kernels"]["switched_mlp"]["calls"] == 2
    if case == "decode_kv_split":
        # a decode over the head_dim-split cache exchanges partial scores
        # (one reduce-scatter a layer) and q and the output (all-to-all)
        assert counts["reduce_scatter"] == 2
        assert counts["all_to_all"] == 4
    # collectives.WIRE counts what the record holds, on the fake backend
    # and through the gloo world's arena alike
    for rec in (fake, gloo):
        wire = {k: v for k, v in rec["wire"].items() if v["calls"]}
        assert {k: v["calls"] for k, v in wire.items()} == counts
        assert {k: v["bytes"] for k, v in wire.items()} == \
            rec["collectives"]["by_kind"]
        assert {k: v["ring_bytes"] for k, v in wire.items()} == \
            rec["collectives"]["ring_by_kind"]
    # all_reduce_sum gathers every part: (n - 1) x payload, where a ring
    # sends 2 (n - 1) / n x payload (equal at n = 2, twice the ring's at
    # the kv-split case's n = 4 over "model")
    by, ring = fake["collectives"]["by_kind"], \
        fake["collectives"]["ring_by_kind"]
    assert by["all_reduce"] == ring["all_reduce"] * (
        2 if case == "decode_kv_split" else 1)
    assert by["all_gather"] == ring["all_gather"]


def test_a_refused_cell_is_written_with_the_refusal():
    """The smoke xLSTM's 4 heads over a model axis of 3: neither divides
    the other (heads below |model| serve where |model| is a multiple of
    them, ROADMAP item 16b), a width the port still refuses."""
    cfg = _smoke("xlstm-1.3b")
    shape = B.ShapeConfig("decode_smoke", "decode", 64, 8)
    cell = dryrun.run_cell("xlstm-1.3b", "decode_smoke", "single",
                           cfg=cfg, shape=shape, mesh_shape=(1, 3),
                           device="cpu")
    with pytest.raises(NotImplementedError) as e:
        M.check_mesh_servable(cfg, MeshShape((1, 3)), 8)
    assert cell["ok"] is False and cfg.n_heads == 4
    assert cell["error"] == f"NotImplementedError: {e.value}"
    assert "heads=4" in cell["error"]
    assert cell["chips"] == 3 and cell["n_params"] > 0
    assert not torch.distributed.is_initialized()


CELL = {"arch": "olmo-1b", "shape": "decode_32k", "mesh": "single",
        "chips": 256, "ok": True, "model_flops": 3.0e11,
        "memory": {"peak_bytes": 3 * 2**30}, "fits_80g": True,
        "cost": {"flops_per_chip": 2.0e10, "bytes_per_chip": 6.7e9},
        "collectives": {"wire_bytes_per_chip": 1.5e8,
                        "internode_bytes_per_chip": 1.0e8}}


def test_roofline_terms_use_the_h100_rates():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW,
            dryrun.IB_BW, dryrun.NODE_SIZE) == (989e12, 3.35e12, 450e9,
                                                50e9, 8)
    r = dryrun.roofline_terms(CELL)
    assert r["t_compute_s"] == pytest.approx(2.0e10 / 989e12)
    assert r["t_memory_s"] == pytest.approx(6.7e9 / 3.35e12)
    assert r["t_collective_s"] == pytest.approx(0.5e8 / 450e9 + 1.0e8 / 50e9)
    assert r["bottleneck"] == "collective"
    assert r["useful_flops_ratio"] == pytest.approx(3.0e11 / (2.0e10 * 256))
    assert r["roofline_frac"] == pytest.approx(r["t_compute_s"]
                                               / r["t_collective_s"])


def test_load_cells_and_fmt_table(tmp_path):
    refused = {"arch": "xlstm-1.3b", "shape": "train_4k", "mesh": "single",
               "chips": 256, "ok": False,
               "error": "NotImplementedError: mesh {'data': 16, 'model': "
                        "16} does not divide the sharded train path of "
                        "xlstm-1.3b at microbatch 8 (the microbatch over "
                        "the data axes, or below them its 4094 positions "
                        "over them with ssm.chunk=256 within a rank's "
                        "slice; d_up=2816 over model): the reference "
                        "falls back to compiler-placed sharding there, the "
                        "port refuses (ROADMAP queue 3, layout "
                        "departures)"}
    for c in (CELL, refused):
        with open(tmp_path / f"{c['arch']}__{c['shape']}__single.json",
                  "w") as f:
            json.dump(c, f)
    with open(tmp_path / "olmo-1b__decode_32k__single__other.json", "w") as f:
        json.dump(CELL, f)
    cells = roofline.load_cells(str(tmp_path))
    assert [c["arch"] for c in cells] == ["olmo-1b", "xlstm-1.3b"]
    assert cells[0]["roofline"] == dryrun.roofline_terms(CELL)
    assert "roofline" not in cells[1]
    table = roofline.fmt_table(cells).splitlines()
    assert table[0].endswith("| fits 80 GB |") and len(table) == 4
    assert table[2].startswith("| olmo-1b | decode_32k | 0.0000 | 0.0020 |")
    assert table[2].endswith("| coll | 0.06 | 3.0 | Y |")
    assert table[3].startswith("| xlstm-1.3b | train_4k | REFUSED: does "
                               "not divide")
    assert "or below them its 4094 positions over them" in table[3]
    assert set(roofline.LEVERS) == {"compute", "memory", "collective"}
    assert len(roofline.load_cells(str(tmp_path), "other")) == 1
