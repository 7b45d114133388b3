"""Deterministic, seekable, shardable synthetic data pipeline (counterpart
of ``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step, host_id): ``batch_at(step)``
seeds a CPU ``torch.Generator`` from the three, so a restart replays no
data and needs no pipeline checkpoint: after restoring the state at step
k, training resumes with ``batch_at(k)`` and the run equals an
uninterrupted one bitwise.  Per-host slicing (``host_id``/``n_hosts``)
generates only the local rows.

The stream is the reference's construction: Zipf-ish marginals with a
Markov backbone (each token follows its predecessor through the fixed map
``(prev * 31 + shift) % vocab`` with probability 1/2, else it is the Zipf
draw).  It is drawn from a ``torch.Generator``, not from ``jax.random``,
so its tokens differ from the reference's; tests that compare the two
packages feed both the same batch.  The batch is made on the CPU, whatever
device trains on it, so one seed gives one stream everywhere.  On a mesh
every rank draws the global batch as one device does and keeps its rows
of it, or below the data axes its slice of every row's positions
(``local_batch``), so the mesh trains on one card's tokens.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import dp_axes


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> dict:
        return batch_at(self, step)


def _generator(seed: int, step: int, host_id: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step, host_id): the reference
    folds the step and the host into its key."""
    state = np.random.SeedSequence([seed, step, host_id]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _markov_tokens(gen, batch, seq_len, vocab):
    """Zipf marginals + first-order Markov structure (learnable bigrams)."""
    # Zipf-ish marginal via exponential transform of uniforms in [1e-6, 1)
    u = torch.rand((batch, seq_len), generator=gen) * (1 - 1e-6) + 1e-6
    ranks = torch.floor(torch.exp(u * math.log(float(vocab)))) - 1.0
    base = ranks.to(torch.int32) % vocab
    # Markov backbone: with p=0.5, token t+1 = f(token t), else the draw
    follow = torch.rand((batch, seq_len), generator=gen) < 0.5
    shift = int(torch.randint(1, 977, (), generator=gen))
    toks = torch.empty_like(base)
    prev = base[:, 0]
    for t in range(seq_len):
        prev = torch.where(follow[:, t], (prev * 31 + shift) % vocab,
                           base[:, t])
        toks[:, t] = prev
    return toks


def batch_at(ds: SyntheticLM, step: int) -> dict:
    """{"inputs": (local_B, S) int32, "labels": (local_B, S) int32} on the
    CPU; the labels are the inputs shifted by one."""
    gen = _generator(ds.seed, step, ds.host_id)
    toks = _markov_tokens(gen, ds.local_batch, ds.seq_len + 1, ds.vocab)
    return {"inputs": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def local_batch(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """This data rank's part of a global batch (``batch_at`` of a dataset
    with one host): its ``collectives.local_rows`` of each of the
    ``grad_accum`` microbatches, in microbatch order, so that slice i of
    what it returns is its part of the single device's microbatch i.  A
    microbatch whose rows do not divide over the data axes is split by
    sequence over them (``activations.sequence_split``): every row, and
    the rank's slice of the positions (dim 1 of every leaf: the tokens,
    the labels, an embeddings input), data rank i positions [i S / g,
    (i + 1) S / g)."""
    dp = dp_axes(mesh)
    g, i = mesh.size(dp), mesh.index(dp)

    def part(t):
        mbs = t.reshape(grad_accum, t.shape[0] // grad_accum, *t.shape[1:])
        if mbs.shape[1] % g:
            n = t.shape[1] // g
            mbs = mbs[:, :, i * n:(i + 1) * n]
        else:
            mbs = mbs[:, C.local_rows(mesh, dp, mbs.shape[1])]
        return mbs.reshape(-1, *mbs.shape[2:]).contiguous()
    return {k: part(v) for k, v in batch.items()}
