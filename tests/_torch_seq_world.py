"""One rank of the 8-rank gloo world of tests/test_torch_seq_train.py (a
(4, 2) ("data", "model") mesh on the CPU), and the cases the test and the
ranks share.  Its data axis of 4 is wider than microbatches of 1 and 2
rows, so every microbatch trains split by sequence over the data ranks:
each holds every row and 16 of the 64 positions (two of its four slices
have neighbours on both sides).  Imports torch and the port only: the
reference stays in the parent.

Each rank runs every case on the inputs the parent saved as
``inputs.pt`` and saves one payload, ``rank<r>.pt``: ``loss_and_grads``
of every arch case at (1 row, grad_accum 1) and (2 rows, grad_accum 2),
the first again under remat, the MoE's routing over the global token
groups, attention's gradients through the gather of k and v along the
sequence (and through an unsummed gather, which must fail), and a
``Trainer`` whose checkpoint the parent restores on one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESH = (4, 2)
RANKS = MESH[0] * MESH[1]
SEQ = 64
# every case's blocks: a rank's slice of 16 positions holds two query
# blocks and two SSD / mLSTM chunks
BLOCK = 8
# (arch, overrides of the smoke config); the ApproxFFN at error bound 1.4
# so that both kinds of label occur at a random init
APPROX = dict(enable=True, route_scope="tick", error_bound=1.4)
MOE = dict(scan_chunk=32, capacity_factor=0.8)
CASES = {
    "internlm2": ("internlm2-1.8b", dict(approx=APPROX)),
    "internlm2-kv1": ("internlm2-1.8b", dict(n_kv_heads=1)),
    "mixtral-ep": ("mixtral-8x7b", dict(moe=MOE)),
    "mixtral-tp": ("mixtral-8x7b", dict(moe=dict(MOE, n_experts=3))),
    "internvl2": ("internvl2-76b", {}),
    "zamba2": ("zamba2-2.7b", dict(approx=APPROX)),
    "xlstm": ("xlstm-1.3b", {}),
}
# (microbatch rows, grad_accum): global batches of 1 and 4 rows
BATCHES = ((1, 1), (2, 2))
# the MoE's routing on its own: (case, rows) on seeded activations
MOE_RUNS = [(c, b) for c in ("mixtral-ep", "mixtral-tp") for b in (1, 2)]
# attention's k/v gradient: rows, heads, head_dim
ATTN = dict(batch=2, heads=4, hd=16)
TRAIN = dict(batch=2, seq=SEQ, lr=1e-3, steps=2)


def cfg(smoke_config, get_config, case: str, remat: bool = False):
    """The case's smoke config (the reference's or the port's registry
    functions), float32, blocks of ``BLOCK``."""
    arch, over = CASES[case]
    c = smoke_config(get_config(arch))
    kw = {k: dataclasses.replace(getattr(c, k), **v) if isinstance(v, dict)
          else v for k, v in over.items()}
    return dataclasses.replace(
        c, remat=remat, q_block=BLOCK, kv_block=BLOCK,
        ssm=dataclasses.replace(c.ssm, chunk=BLOCK), **kw)


def _port_cfg(case: str, remat: bool = False):
    from repro_torch.configs.registry import get_config, smoke_config
    return cfg(smoke_config, get_config, case, remat)


def batch(cfg_, rows: int, seed: int) -> dict:
    """A seeded numpy batch of ``rows`` rows: tokens (or embeddings) and
    labels."""
    rng = np.random.default_rng(seed)
    if cfg_.input_mode == "embeddings":
        inputs = rng.standard_normal((rows, SEQ, cfg_.d_model)) \
            .astype(np.float32)
    else:
        inputs = rng.integers(0, cfg_.vocab, (rows, SEQ)).astype(np.int32)
    return {"inputs": inputs,
            "labels": rng.integers(0, cfg_.vocab, (rows, SEQ))
            .astype(np.int32)}


def grads_case(cfg_, tree, bt: dict, rows: int, ga: int, mesh=None):
    """``loss_and_grads`` from the reference tree ``tree`` on ``bt``
    (microbatches of ``rows`` rows): the loss, the metrics and the
    gradients gathered whole; on ``mesh`` the rank's part, split by
    sequence, with its collectives counted."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import local_batch
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    params = params_from_jax(cfg_, tree, device="cpu")
    if mesh is not None:
        C.shard_params(mesh, params)
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    local = {k: torch.from_numpy(v) for k, v in bt.items()}
    if mesh is not None:
        local = local_batch(local, mesh, ga)
    C.reset_counts()
    with S.train_mesh_context(mesh, rows):
        loss, metrics, grads = S.loss_and_grads(cfg_, params, local, ga)
    counts = dict(C.COUNTS)
    if mesh is not None:
        grads = {k: C.gather_whole(g, named[k]._pspec, mesh)
                 for k, g in grads.items()}
    return {"loss": loss.numpy(),
            "metrics": {k: v.numpy() for k, v in metrics.items()},
            "grads": {k: g.numpy() for k, g in grads.items()},
            "counts": counts}


def moe_case(cfg_, tree: dict, x: np.ndarray, mesh):
    """The first block's MoE on seeded activations ``x`` (B, S, d), each
    data rank its slice of the positions: the output and the aux loss,
    each (token, choice)'s expert and kept flag (gathered whole along
    the sequence), and the drop count."""
    from repro_torch.models import moe
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.activations import (mesh_context,
                                                  sequence_shard)
    from repro_torch.sharding.rules import dp_axes, param_pspecs
    p = moe.MoE(cfg_, "cpu")
    p.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    prefix = "blocks.0.moe"
    specs, _ = param_pspecs(mesh, {f"{prefix}.{k}": v
                                   for k, v in p.state_dict().items()})
    for k, prm in p.named_parameters():
        prm.data = C.shard_tensor(mesh, prm.data, specs[f"{prefix}.{k}"])
        prm._pspec = specs[f"{prefix}.{k}"]
    b, s, d = x.shape
    dp = dp_axes(mesh)
    n = s // mesh.size(dp)
    i = mesh.index(dp)
    xl = torch.from_numpy(np.ascontiguousarray(x[:, i * n:(i + 1) * n]))
    whole = lambda t: C.all_gather(t.contiguous(), dp, 1, mesh)
    with mesh_context(mesh, b), torch.no_grad():
        y, aux = moe.moe_fwd(cfg_, p, xl)
        router = C.gather_whole(p.router, p.router._pspec, mesh)
        r = moe.route_global(cfg_, router, xl.reshape(-1, d), mesh, dp,
                             sequence_shard(n), b)
        k = cfg_.moe.top_k
        kept = torch.zeros(b * n * k, dtype=torch.bool)
        kept[r.order.long()] = r.keep
        dropped, total = moe.dropped_choices(cfg_, p, xl)
    return {"y": whole(y).numpy(), "aux": aux.numpy(),
            "gate_idx": whole(r.gate_idx.reshape(b, n, k)).numpy(),
            "kept": whole(kept.reshape(b, n, k)).numpy(),
            "dropped": (int(dropped), int(total))}


def attention_case(inp: dict, mesh, unsummed: bool = False):
    """Causal attention (``layers._self_attention``) of seeded q, k, v
    (B, S, H, hd), each data rank its slice of the positions: the
    gradients of sum(out * w) for q, k and v, gathered whole along the
    sequence.  ``unsummed``: k and v gathered with ``all_gather``, whose
    backward keeps the rank's slice of the gradient without summing it
    over the data ranks (the pitfall)."""
    from repro_torch.models import layers as L
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import sequence
    from repro_torch.sharding.activations import mesh_context
    from repro_torch.sharding.rules import dp_axes
    c = _port_cfg("internlm2")
    c = dataclasses.replace(c, n_heads=ATTN["heads"],
                            n_kv_heads=ATTN["heads"], head_dim=ATTN["hd"])
    dp = dp_axes(mesh)
    n = SEQ // mesh.size(dp)
    i = mesh.index(dp)
    cut = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[:, i * n:(i + 1) * n]))
    q, k, v = (cut(inp[t]).requires_grad_(True) for t in ("q", "k", "v"))

    def plain_gather(t, shard, upto=None):
        whole = C.all_gather(t, shard.dp, 1, shard.mesh)
        return whole if upto is None or upto >= whole.shape[1] \
            else whole[:, :upto].contiguous()
    real = L.gather_sequence
    if unsummed:
        L.gather_sequence = plain_gather
    try:
        with mesh_context(mesh, ATTN["batch"]):
            o = L._self_attention(c, q, k, v)
            gs = torch.autograd.grad((o * cut(inp["w"])).sum(), (q, k, v))
    finally:
        L.gather_sequence = real
    assert sequence.gather_sequence is real
    with torch.no_grad():
        return {name: C.all_gather(g, dp, 1, mesh).numpy()
                for name, g in zip("qkv", gs)}


def attention_single(inp: dict) -> dict:
    """The same gradients on one device."""
    from repro_torch.models import layers as L
    c = dataclasses.replace(_port_cfg("internlm2"), n_heads=ATTN["heads"],
                            n_kv_heads=ATTN["heads"], head_dim=ATTN["hd"])
    q, k, v = (torch.from_numpy(inp[t]).requires_grad_(True)
               for t in ("q", "k", "v"))
    o = L._self_attention(c, q, k, v)
    gs = torch.autograd.grad((o * torch.from_numpy(inp["w"])).sum(),
                             (q, k, v))
    return {name: g.numpy() for name, g in zip("qkv", gs)}


def trainer(cfg_, ckpt_dir: str, mesh=None):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    ds = SyntheticLM(vocab=cfg_.vocab, seq_len=TRAIN["seq"],
                     global_batch=TRAIN["batch"], seed=3)
    tc = TrainerConfig(total_steps=TRAIN["steps"], ckpt_every=TRAIN["steps"],
                       ckpt_dir=ckpt_dir, base_lr=TRAIN["lr"], warmup=0,
                       log_every=100)
    return Trainer(cfg_, tc, ds, mesh=mesh, seed=0, device="cpu")


def gathered_params(state, mesh=None) -> dict:
    """{name: ndarray} of a train state's parameters, whole."""
    from repro_torch.sharding import collectives as C
    return {k: (p.detach() if mesh is None else
                C.gather_whole(p.detach(), p._pspec, mesh)).numpy()
            for k, p in state["params"].named_parameters()}


def run(rank: int, out_dir: str):
    """One rank: every case on the inputs in ``inputs.pt``; its payload
    to ``rank<r>.pt``."""
    from _torch_mesh_world import _wait_for_inputs
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh(data=MESH[0], model=MESH[1])
    inp = _wait_for_inputs(f"{out_dir}/inputs.pt")
    out = {"coords": mesh.coords, "grads": {}, "remat": {}, "moe": {}}
    for case in CASES:
        for rows, ga in BATCHES:
            K.slstm_scan.launches = 0
            out["grads"][case, rows, ga] = dict(
                grads_case(_port_cfg(case), inp["trees"][case],
                           inp["batches"][case, rows, ga], rows, ga, mesh),
                slstm=K.slstm_scan.launches)
        rows, ga = BATCHES[0]
        out["remat"][case] = grads_case(
            _port_cfg(case, remat=True), inp["trees"][case],
            inp["batches"][case, rows, ga], rows, ga, mesh)
    for case, rows in MOE_RUNS:
        out["moe"][case, rows] = moe_case(
            _port_cfg(case), inp["moe_trees"][case], inp["moe_x"][case, rows],
            mesh)
    out["attn"] = attention_case(inp["attn"], mesh)
    out["attn_unsummed"] = attention_case(inp["attn"], mesh, unsummed=True)
    tr = trainer(_port_cfg("internlm2"), f"{out_dir}/ckpt", mesh)
    tr.run()
    out["train"] = {"history": tr.history,
                    "params": gathered_params(tr.state, mesh)}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
