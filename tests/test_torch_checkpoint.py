"""The PyTorch port's checkpointing, data pipeline and Trainer: the ports
of tests/test_checkpoint.py's seven cases on the smoke internlm2-1.8b
config with the ApproxFFN (atomic save/restore, keep-k, a partial write
ignored, bitwise resume, injected preemption with auto-restore, data
determinism and host slicing, a manifest free of mesh information), a
bfloat16 round trip, and the reference's checkpoints and the port's read
across the packages exactly."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as C
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.convert import train_state_from_jax, train_state_to_tree
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.runtime import steps as TS
from repro_torch.runtime.trainer import PreemptionError, Trainer, TrainerConfig


def _tiny_cfg():
    cfg = smoke_config(get_config("internlm2-1.8b"))
    return dataclasses.replace(cfg, vocab=128, approx=dataclasses.replace(
        cfg.approx, enable=True, route_scope="tick"))


def _ds(cfg):
    return SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _state_tensors(cfg, state):
    return _leaves(train_state_to_tree(cfg, state))


def test_save_restore_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"m": [torch.ones(3), torch.zeros(2)]},
             "step": torch.tensor(7, dtype=torch.int32)}
    C.save(str(tmp_path), 7, state)
    got, step = C.restore(str(tmp_path))
    assert step == 7
    flat_a, flat_b = _leaves(state), _leaves(got)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(got["opt"]["m"], list)


def test_bf16_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)) \
        .to(torch.bfloat16)
    state = {"w": w, "e": {}, "n": torch.tensor([1, -2], dtype=torch.int64)}
    C.save(str(tmp_path), 3, state)
    man = json.load(open(tmp_path / "step_000000003" / "manifest.json"))
    assert man["paths"]["w"]["dtype"] == "bfloat16"
    got, _ = C.restore(str(tmp_path))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert got["e"] == {} and torch.equal(got["n"], state["n"])


def test_keep_k_gc(tmp_path):
    state = {"x": torch.zeros(1)}
    for s in range(6):
        C.save(str(tmp_path), s, state, keep_k=3)
    assert sorted(C.all_steps(str(tmp_path))) == [3, 4, 5]


def test_atomicity_partial_tmp_ignored(tmp_path):
    state = {"x": torch.ones(2)}
    C.save(str(tmp_path), 1, state)
    # a writer dying mid-checkpoint: a stray tmp dir and a step dir
    # without a manifest must both be ignored
    os.makedirs(tmp_path / "tmp.2")
    os.makedirs(tmp_path / "step_000000002")
    assert C.latest_step(str(tmp_path)) == 1
    got, step = C.restore(str(tmp_path))
    assert step == 1 and got is not None


def test_bitwise_resume(tmp_path):
    """save@5 -> restart -> train to 10 == uninterrupted train to 10."""
    cfg = _tiny_cfg()
    tc = TrainerConfig(total_steps=10, ckpt_every=5, log_every=100,
                       ckpt_dir=str(tmp_path / "a"))
    t1 = Trainer(cfg, tc, _ds(cfg), seed=3, device="cpu")
    t1.run()

    # interrupted twin: run to 5 (ckpt), a new Trainer resumes 5 -> 10
    tc2 = TrainerConfig(total_steps=5, ckpt_every=5, log_every=100,
                        ckpt_dir=str(tmp_path / "b"))
    Trainer(cfg, tc2, _ds(cfg), seed=3, device="cpu").run()
    tc3 = TrainerConfig(total_steps=10, ckpt_every=5, log_every=100,
                        ckpt_dir=str(tmp_path / "b"))
    t3 = Trainer(cfg, tc3, _ds(cfg), seed=3, device="cpu")
    assert t3.start_step == 5
    t3.run()

    a, b = _state_tensors(cfg, t1.state), _state_tensors(cfg, t3.state)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(t3.state["step"]) == 10
    assert [r["loss"] for r in t1.history[5:]] == \
        [r["loss"] for r in t3.history]


def test_injected_preemption_then_auto_restore(tmp_path):
    """A preempted job restarted with the same command line recovers."""
    cfg = _tiny_cfg()
    ckpt = str(tmp_path / "ck")
    tc = TrainerConfig(total_steps=10, ckpt_every=2, log_every=100,
                       ckpt_dir=ckpt, fail_at=7)
    with pytest.raises(PreemptionError):
        Trainer(cfg, tc, _ds(cfg), seed=0, device="cpu").run()
    assert C.latest_step(ckpt) == 6
    tc2 = TrainerConfig(total_steps=10, ckpt_every=2, log_every=100,
                        ckpt_dir=ckpt)
    t = Trainer(cfg, tc2, _ds(cfg), seed=0, device="cpu")
    assert t.start_step == 6
    out = t.run()
    assert out["steps"] == 4 and math.isfinite(out["final_loss"])


def test_data_determinism_and_host_slicing():
    ds = SyntheticLM(vocab=512, seq_len=64, global_batch=8)
    a = ds.batch_at(3)
    b = ds.batch_at(3)
    assert torch.equal(a["inputs"], b["inputs"])
    c = ds.batch_at(4)
    assert not torch.equal(a["inputs"], c["inputs"])
    assert a["inputs"].dtype == torch.int32 and a["inputs"].shape == (8, 64)
    # shifted labels
    assert torch.equal(a["inputs"][:, 1:], a["labels"][:, :-1])
    # host slicing: different hosts draw different rows
    h0 = SyntheticLM(vocab=512, seq_len=64, global_batch=8, host_id=0,
                     n_hosts=2)
    h1 = SyntheticLM(vocab=512, seq_len=64, global_batch=8, host_id=1,
                     n_hosts=2)
    assert h0.local_batch == 4
    assert not torch.equal(h0.batch_at(0)["inputs"], h1.batch_at(0)["inputs"])


def _markov_split(toks: np.ndarray, vocab: int):
    """(share of transitions that follow the affine map with the batch's
    most common shift, the tokens that do not follow it)."""
    prev, nxt = toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)
    shifts = (nxt - prev * 31) % vocab
    follows = shifts == np.bincount(shifts.ravel()).argmax()
    return float(np.mean(follows)), nxt[~follows]


def test_stream_has_the_references_structure():
    """The stream draws from a torch.Generator, so its tokens are not the
    reference's; its construction is: in range, about half of the
    transitions follow the Markov map, the others are Zipf draws skewed
    toward small ids (as in the reference's own stream)."""
    pytest.importorskip("jax")
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    vocab = 512
    ours = SyntheticLM(vocab=vocab, seq_len=256, global_batch=16, seed=1)
    ref = JSyntheticLM(vocab=vocab, seq_len=256, global_batch=16, seed=1)
    for ds in (ours, ref):
        toks = np.asarray(ds.batch_at(2)["inputs"])
        assert toks.min() >= 0 and toks.max() < vocab
        share, draws = _markov_split(toks, vocab)
        assert 0.45 < share < 0.65
        assert np.mean(draws < vocab // 8) > 0.5


def test_elastic_restore_changes_nothing(tmp_path):
    """Restore is device- and mesh-agnostic: the manifest carries no mesh
    information, and the state restores onto the CPU as saved."""
    cfg = _tiny_cfg()
    tc = TrainerConfig(total_steps=2, ckpt_every=2, log_every=100,
                       ckpt_dir=str(tmp_path))
    t = Trainer(cfg, tc, _ds(cfg), seed=1, device="cpu")
    t.run()
    state, step = C.restore(str(tmp_path))
    assert step == 2
    man = json.load(open(tmp_path / "step_000000002" / "manifest.json"))
    assert "mesh" not in json.dumps(man)
    back = train_state_from_jax(cfg, state, device="cpu")
    for x, y in zip(_state_tensors(cfg, back), _state_tensors(cfg, t.state)):
        assert torch.equal(x, y)


def _jax_smoke_state():
    jax = pytest.importorskip("jax")
    from repro.configs.registry import get_config as jget_config
    from repro.configs.registry import smoke_config as jsmoke
    from repro.runtime import steps as JS
    jax.config.update("jax_platform_name", "cpu")
    jcfg = jsmoke(jget_config("internlm2-1.8b"))
    jcfg = dataclasses.replace(jcfg, approx=dataclasses.replace(
        jcfg.approx, enable=True, route_scope="tick"))
    state = JS.init_train_state(jax.random.PRNGKey(4), jcfg)
    # one step, so the moments and the counter are not zero
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
    state, _ = jax.jit(JS.make_train_step(jcfg, warmup=0, total_steps=10))(
        state, {"inputs": toks[:, :-1], "labels": toks[:, 1:]})
    tcfg = smoke_config(get_config("internlm2-1.8b"))
    tcfg = dataclasses.replace(tcfg, approx=dataclasses.replace(
        tcfg.approx, enable=True, route_scope="tick"))
    return jax, tcfg, state


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint written by the reference's ``save`` from a JAX smoke
    train state, restored by the port, equals ``train_state_from_jax`` of
    that state exactly."""
    jax, tcfg, jstate = _jax_smoke_state()
    from repro import checkpoint as JC
    JC.save(str(tmp_path), 1, jstate)
    tree, step = C.restore(str(tmp_path))
    assert step == 1
    got = train_state_from_jax(tcfg, tree, device="cpu")
    want = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                device="cpu")
    assert int(got["step"]) == int(want["step"]) == 1
    a, b = _state_tensors(tcfg, got), _state_tensors(tcfg, want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The other way: the port's checkpoint of a converted state reads
    back through the reference's ``restore`` as the same pytree."""
    jax, tcfg, jstate = _jax_smoke_state()
    from repro import checkpoint as JC
    state = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    C.save(str(tmp_path), 1, train_state_to_tree(tcfg, state))
    back, step = JC.restore(str(tmp_path))
    assert step == 1
    want = jax.tree_util.tree_flatten_with_path(jstate)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_trainer_state_is_a_train_state():
    cfg = _tiny_cfg()
    state = TS.init_train_state(0, cfg, device="cpu")
    named = dict(state["params"].named_parameters())
    assert all(p.requires_grad for p in named.values())
    assert state["opt"]["m"].keys() == named.keys()
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
