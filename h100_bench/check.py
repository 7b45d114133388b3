"""The comparison that decides ``correct``, on the reference's side.

What it is given of the run: the served tokens of a sample of finished
requests, their prompts, and the schedule of the ticks that carried them
(which rows of which requests each tick processed, at which positions).
The schedule is the server's batching, which the reference cannot know
otherwise; everything numeric it works out again itself from the seed's
weights and the token ids: the tick router's class for every row of those
ticks, each class's capacity in the tick, the decision for each position
(``decisions``), and then the forward pass of each sampled sequence
(``reference.logits``).

Each tick's capacity rung and resident set are the frozen policy's
(``policy.replay``) over the stats the server handed its controllers;
``counts_off`` holds those stats to the reference's own routing on the
decode ticks it routes whole.

The number compared is the widest gap by which a served token's logit
lies below the reference's best at that position, in units of the
standard deviation of the reference's logits there (``served_gap``).
The control (``control_gap``) puts the reference in the program's place
at a lower precision, routing and all, and reads the gap of the token
that it puts first.  Nothing here imports the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h100_bench import reference as R


@dataclasses.dataclass
class Tick:
    """One tick: ``chunk`` rows are (slot, offset) of a (batch, S) chunk,
    else one row a slot; ``rows`` is an int64 array of (rid, slot, start,
    n) for each request the tick processed.  Where the server decides
    them as it goes, ``residency`` is the tick's resident library ids and
    ``point`` its capacity rung (exact_frac, per-class invoke fracs,
    slack), as the run recorded them; ``obs`` is how many decode ticks
    the server's controllers had observed before it (``policy.replay``
    gives the rung and set that the policy holds then)."""

    chunk: int          # S of a chunk tick, 0 for a decode tick
    rows: np.ndarray
    residency: tuple | None = None
    point: tuple | None = None
    obs: int = 0


def capacity(t: int, frac: float, slack: float = 1.0) -> int:
    """Rows a class may take among ``t`` rows."""
    return max(min(int(t * frac * slack), t), 1)


def tier_margins(base: float, spread: float = 2.0,
                 scale: float = 4.0) -> np.ndarray:
    """The QoS tiers' exact-logit margins: the (tight, base, loose) bounds
    (base / spread, base, base * spread), each margin scale * log(base /
    bound), in float32."""
    bounds = (base / spread, base, base * spread)
    return np.asarray([scale * np.log(base / b) for b in bounds], np.float32)


def decisions(cfg: dict, batch: int, ticks: list, seqs: dict,
              route_logits, wanted: set, tiers: dict | None = None,
              margins: np.ndarray | None = None,
              counts: dict | None = None) -> dict:
    """{rid: int64 array of the decision at each position} for the
    requests in ``wanted``: 0 exact, c >= 1 approximator c (of the
    library, where there is one), -1 dropped.

    Each row takes the argmax of the router's logits (``route_logits``
    of token ids), its request's tier margin (``tiers``, ``margins``)
    added to the exact logit.  Under a residency a library class maps to
    its resident slot, and one not resident is served exact.  Each tick's
    rows are the active rows of a (batch x S) row batch in slot-major
    order; a row keeps its class when fewer earlier active rows of the
    same class came before it than the class's capacity (exact_frac for
    class 0, the invoke fraction of the slot for the others, of batch x
    S rows, at the tick's rung or the configuration's), and is dropped
    otherwise.

    ``counts``, where given, receives for every tick that carried a
    wanted request (all of whose rows are routed here) {tick: (routed
    counts over the library, routed counts over the served classes,
    dropped rows, ambiguous rows)}; a row is ambiguous where its top two
    router logits lie within two bf16 steps, so that the program's
    rounding may route it either way."""
    a = cfg["approx"]
    n_slots = a["n_approx"]
    want = np.array(sorted(wanted), np.int64)
    # every (rid, slot, start, n) entry of every tick that carried a
    # wanted request, with its tick's index and chunk width
    ent, ent_t, ent_s = [], [], []
    for k, tk in enumerate(ticks):
        r = tk.rows
        if len(r) and np.isin(r[:, 0], want).any():
            ent.append(r)
            ent_t.append(np.full(len(r), k))
            ent_s.append(np.full(len(r), max(tk.chunk, 1)))
    out = {q: np.full(len(seqs[q]), -2, np.int64) for q in wanted}
    if not ent:
        return out
    ent, ent_t, ent_s = (np.concatenate(ent), np.concatenate(ent_t),
                         np.concatenate(ent_s))
    n = ent[:, 3]
    first = np.repeat(np.cumsum(n) - n, n)
    off = np.arange(int(n.sum())) - first          # offset within entry
    t_id = np.repeat(ent_t, n)
    rid, width = np.repeat(ent[:, 0], n), np.repeat(ent_s, n)
    row = np.repeat(ent[:, 1], n) * width + off
    pos = np.repeat(ent[:, 2], n) + off
    width = width * batch
    # token ids through one flat array of every sequence
    keys = sorted(seqs)
    base = dict(zip(keys, np.cumsum([0] + [len(seqs[q]) for q in keys])))
    flat = np.concatenate([seqs[q] for q in keys])
    tokens = flat[np.array([base[q] for q in rid.tolist()]) + pos]
    uniq, inv = np.unique(tokens, return_inverse=True)
    lg = np.asarray(route_logits(uniq), np.float32)[inv]
    # one bf16 step at each row's largest logit, before any margin
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(lg).max(1), 1e-30)))
                   - 7)
    if tiers is not None and margins is not None:
        tier = np.array([tiers[q] for q in rid.tolist()], np.int64)
        lg[:, 0] += margins[tier]
    lib_cls = lg.argmax(1)
    cls = lib_cls
    res_ticks = [k for k in np.unique(t_id).tolist()
                 if ticks[k].residency is not None]
    if res_ticks:
        slot_map = np.zeros((len(ticks), lg.shape[1]), np.int64)
        for k in res_ticks:
            slot_map[k, np.asarray(ticks[k].residency) + 1] = \
                np.arange(1, n_slots + 1)
        cls = slot_map[t_id, lib_cls]
    n_cls = n_slots + 1
    # rank of each row among the earlier rows of its class in its tick
    order = np.lexsort((row, cls, t_id))
    key = (t_id * n_cls + cls)[order]
    first = np.r_[0, np.flatnonzero(np.diff(key)) + 1]
    starts = np.repeat(first, np.diff(np.r_[first, len(key)]))
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order)) - starts
    static = (a["exact_frac"], (a["invoke_frac"],) * n_slots, 1.0)
    caps = {}
    for k, w in set(zip(t_id.tolist(), width.tolist())):
        ef, fr, sl = ticks[k].point or static
        caps[k, w] = [capacity(w, ef, sl)] + [capacity(w, f, sl) for f in fr]
    cap = np.array([caps[k, w][c] for k, w, c in
                    zip(t_id.tolist(), width.tolist(), cls.tolist())])
    dec = np.where(rank < cap, np.where(cls > 0, lib_cls, 0), -1)
    if counts is not None:
        top2 = np.sort(lg, 1)[:, -2:]
        amb = top2[:, 1] - top2[:, 0] <= 2 * step
        for k in np.unique(t_id).tolist():
            m = t_id == k
            counts[k] = (np.bincount(lib_cls[m], minlength=lg.shape[1]),
                         np.bincount(cls[m], minlength=n_cls),
                         int((dec[m] == -1).sum()), int(amb[m].sum()))
    for q in wanted:
        m = rid == q
        out[q][pos[m]] = dec[m]
    return out


def _normalized_gap(ref: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """(max over the vocab - ref[tok]) / std over the vocab, per row."""
    best = ref.amax(-1)
    picked = ref.gather(-1, tok[:, None])[:, 0]
    return (best - picked) / ref.std(-1)


def _sequences(requests: dict, rids) -> dict:
    """{rid: the positions the server wrote: prompt + out[:-1]}."""
    return {q: np.concatenate([requests[q]["prompt"],
                               np.asarray(requests[q]["out"][:-1],
                                          np.int32)]).astype(np.int64)
            for q in rids}


def served_gap(cfg: dict, get, batch: int, ticks: list, requests: dict,
               sample: list, device, control_get=None, tiers=None,
               margins=None, counts: dict | None = None) -> dict:
    """The reference's reading of the served tokens of ``sample``:
    {"gap": the widest normalized gap, "tokens": tokens compared,
    "undecided": positions no tick carried}; with ``control_get`` also
    "control_gap": the widest gap of the token that the control puts
    first, the control routing the same rows by its own weights.
    ``counts`` receives the reference's routed counts of the ticks it
    routes whole (``decisions``)."""
    seqs = _sequences(requests, sample)
    all_seqs = _sequences(requests, requests.keys())

    def router(g):
        def route_logits(tokens):
            t = torch.as_tensor(tokens, device=device)
            return R.router_logits(cfg, g, t).cpu().numpy()
        return route_logits

    dec = decisions(cfg, batch, ticks, all_seqs, router(get), set(sample),
                    tiers, margins, counts)
    cdec = decisions(cfg, batch, ticks, all_seqs, router(control_get),
                     set(sample), tiers, margins) \
        if control_get is not None else None
    worst, worst_c, n_tok, undecided = 0.0, 0.0, 0, 0
    for q in sample:
        req = requests[q]
        p_len, out = len(req["prompt"]), np.asarray(req["out"], np.int64)
        seq = torch.as_tensor(seqs[q], device=device)
        at = torch.arange(p_len - 1, p_len - 1 + len(out), device=device)
        undecided += int((dec[q] < -1).sum())
        d = torch.as_tensor(dec[q], device=device)
        ref = R.logits(cfg, get, seq, d, at)
        tok = torch.as_tensor(out, device=device)
        worst = max(worst, float(_normalized_gap(ref, tok).max()))
        n_tok += len(out)
        if control_get is not None:
            c = R.logits(cfg, control_get, seq,
                         torch.as_tensor(cdec[q], device=device), at)
            worst_c = max(worst_c, float(
                _normalized_gap(ref, c.argmax(-1)).max()))
            del c
        del ref
    res = {"gap": worst, "tokens": n_tok, "undecided": undecided}
    if control_get is not None:
        res["control_gap"] = worst_c
    return res


def counts_off(ticks: list, stats: list, counts: dict) -> int:
    """Decode ticks among those the reference routed whole (``counts``,
    from ``decisions``) whose counts, as the program handed them to its
    controllers (``stats[tick.obs]``), differ from the reference's by more
    than its ambiguous rows allow: each may move one row between two
    classes, two counts and so at most two dropped rows."""
    bad = 0
    for k, (lib, cls, dropped, amb) in counts.items():
        tk = ticks[k]
        if tk.chunk:
            continue
        if tk.obs >= len(stats):
            bad += 1
            continue
        s = stats[tk.obs]
        d = int(np.abs(s["class_counts"] - cls).sum()) \
            if len(s["class_counts"]) == len(cls) else 1 << 30
        if s["lib_counts"] is not None:
            d = max(d, int(np.abs(s["lib_counts"] - lib).sum())
                    if len(s["lib_counts"]) == len(lib) else 1 << 30)
        if d > 2 * amb or abs(s["dropped"] - dropped) > 2 * amb:
            bad += 1
    return bad


def float32_view(weights: dict):
    """``get`` of the reference: each weight in float32."""
    return lambda name: weights[name].float()


def fp8_view(weights: dict):
    """``get`` of the control: each matrix rounded to float8 e4m3 with one
    scale per tensor (its largest magnitude at 448), then float32; the
    vectors (norm scales, biases) stay as they are.  Cached, since each
    is read once a sequence."""
    cache = {}

    def get(name):
        if name not in cache:
            w = weights[name].float()
            if w.ndim >= 2:
                s = w.abs().amax().clamp(min=1e-12) / 448.0
                w = (w / s).to(torch.float8_e4m3fn).float() * s
            cache[name] = w
        return cache[name]
    return get
