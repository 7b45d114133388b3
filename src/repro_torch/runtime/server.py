"""Batched decode server loop (counterpart of ``repro/runtime/server.py``).

Continuous batching over a fixed-size slot table (``batch`` concurrent
sequences): finished sequences (EOS, ``max_new`` or ``max_len``) free
their slot, and queued requests fill freed slots each tick, admitted by a
cost model (prompt length minus an aging credit) or in FIFO order.
Prompts are fed token by token through the decode step
(``prefill_chunk=0``, the reference's token-by-token mode); the final
prompt token yields the first sampled token.

The ``max_len`` contract: positions are absolute, never recycled.
``submit()`` enforces ``len(prompt) + max_new <= max_len`` loudly (or
trims the prompt's HEAD under ``overflow="trim"``).

The server runs where its parameters live; the cache, on the same
device, is the dense ``(batch, max_len)`` KV cache (dense family) or the
recurrent states (xLSTM family, which has no KV cache and whose
``--mcma-dispatch`` runs report invocation rate 0: it has no ApproxFFN).
Options of features not ported yet raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.runtime import steps as steps_lib
from repro_torch.runtime.options import ServeOptions

# ServeOptions fields of features this port has not reached, with the
# ROADMAP queue 1 item that ports each; a non-default value raises.
_UNPORTED = {
    "mesh": "item 10 (multiple devices)",
    "autotune": "item 6 (runtime/autotune.py)",
    "qos_tiers": "item 6 (QoS tiers, with apps/ from item 4)",
    "qos_app": "item 6 (QoS tiers, with apps/ from item 4)",
    "library": "item 6 (library residency)",
    "kv_page_size": "item 5 (paged KV cache)",
    "kv_pages": "item 5 (paged KV cache)",
    "prefill_chunk": "item 5 (chunked prefill, decode_chunk)",
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new: int = 32
    error_bound: float | None = None
    tier: int | None = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # set when the server gave up on the request instead of finishing it
    aborted: bool = False
    arrival_tick: int | None = None
    first_token_tick: int | None = None
    arrival_s: float | None = None
    first_token_s: float | None = None


@dataclasses.dataclass
class DrainStats:
    """Typed ``run_until_drained`` summary with dict-style access
    (``stats["ticks"]``; ``None`` fields count as absent)."""

    ticks: int = 0
    wall_s: float = 0.0
    undrained_queued: int = 0
    undrained_inflight: int = 0
    invocation_rate: Optional[float] = None
    dropped_rows: Optional[float] = None
    routed_per_class: Optional[list] = None
    dispatched_per_class: Optional[list] = None
    dropped_frac: Optional[float] = None
    served_invocation_rate: Optional[float] = None
    kv_bytes_resident: Optional[int] = None
    extras: dict = dataclasses.field(default_factory=dict)

    def __getitem__(self, k):
        if k in self.extras:
            return self.extras[k]
        if k in _DRAIN_FIELDS:
            v = getattr(self, k)
            if v is not None:
                return v
        raise KeyError(k)

    def __setitem__(self, k, v):
        if k in _DRAIN_FIELDS and k != "extras":
            setattr(self, k, v)
        else:
            self.extras[k] = v

    def __contains__(self, k):
        return k in self.extras or (
            k in _DRAIN_FIELDS and getattr(self, k) is not None)

    def __iter__(self):
        return iter(self.asdict())

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def asdict(self) -> dict:
        d = {f: getattr(self, f) for f in _DRAIN_FIELDS
             if f != "extras" and getattr(self, f) is not None}
        d.update(self.extras)
        return d

    def keys(self):
        return self.asdict().keys()

    def items(self):
        return self.asdict().items()


_DRAIN_FIELDS = tuple(f.name for f in dataclasses.fields(DrainStats))


def _check_ported(o: ServeOptions, cfg: ModelConfig):
    default = ServeOptions()
    for name, item in _UNPORTED.items():
        if getattr(o, name) != getattr(default, name):
            raise NotImplementedError(
                f"ServeOptions.{name}={getattr(o, name)!r} is not ported "
                f"yet: ROADMAP queue 1, {item}")
    scope = o.route_scope or cfg.approx.route_scope
    if scope != "layer":
        raise NotImplementedError(
            f"route_scope={scope!r} is not ported yet: ROADMAP queue 1, "
            "item 5 (tick-scope plans)")


class DecodeServer:
    def __init__(self, cfg: ModelConfig, params: M.Model, *,
                 options: ServeOptions | None = None):
        """``DecodeServer(cfg, params, options=ServeOptions(...))``: serve
        ``params`` (a ``models.model.Model``) on the device it lives on."""
        o = self.options = options if options is not None else ServeOptions()
        _check_ported(o, cfg)
        if o.admission not in ("cost", "fifo"):
            raise ValueError(f"unknown admission policy: {o.admission!r} "
                             "(expected 'cost' or 'fifo')")
        if o.overflow not in ("reject", "trim"):
            raise ValueError(f"unknown overflow policy: {o.overflow!r} "
                             "(expected 'reject' or 'trim')")
        self.cfg, self.params = cfg, params
        self.device = next(params.parameters()).device
        self.batch, self.max_len, self.eos = o.batch, o.max_len, o.eos
        self.greedy = o.greedy
        self.gen = torch.Generator(device=self.device).manual_seed(o.seed)
        self.use_mcma_dispatch = o.use_mcma_dispatch
        self.backend = o.backend
        self.route_scope = o.route_scope
        self.admission, self.aging, self.overflow = \
            o.admission, float(o.aging), o.overflow
        self.decode = steps_lib.make_decode_step(
            cfg, use_mcma_dispatch=self.use_mcma_dispatch,
            with_stats=self.use_mcma_dispatch, route_scope=self.route_scope,
            backend=self.backend)
        self.invocation_sum = 0.0    # active-slot-weighted invocation sum
        self.active_sum = 0          # total active slots over all ticks
        self.dropped_sum = 0.0       # layer-mean dropped rows over ticks
        self.dispatched_sum = None   # (n+1,) layer-mean dispatched rows
        self.routed_sum = None       # (n+1,) layer-mean routed rows
        self.cache = M.init_cache(cfg, self.batch, self.max_len,
                                  device=self.device)
        self.slots: list[Request | None] = [None] * self.batch
        self.queue: list[Request] = []
        self.remaining_prompt: list[np.ndarray] = \
            [np.zeros((0,), np.int32)] * self.batch
        self.ticks = 0
        self._fresh = None  # lazily-built pristine cache for slot resets
        self._submit_seq = 0

    def submit(self, req: Request):
        """Queue a request; per-request limits are validated HERE, loudly.

        The prompt must be non-empty and ``len(prompt) + max_new <=
        max_len`` must hold; overlong prompts raise under
        ``overflow="reject"`` or keep their LAST ``max_len - max_new``
        tokens under ``overflow="trim"``."""
        req.prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if req.prompt.size == 0:
            raise ValueError(f"request {req.rid}: empty prompt — a request "
                             "must carry at least one prompt token")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new {req.max_new} "
                             "must be >= 1")
        if req.error_bound is not None or req.tier is not None:
            raise NotImplementedError(
                f"request {req.rid} carries a QoS error_bound/tier; QoS "
                "tiers are not ported yet: ROADMAP queue 1, item 6")
        budget = self.max_len - int(req.max_new)
        if req.prompt.size > budget:
            if self.overflow == "reject":
                raise ValueError(
                    f"request {req.rid}: prompt ({req.prompt.size} tokens) "
                    f"+ max_new ({req.max_new}) exceeds max_len "
                    f"({self.max_len}); shorten the prompt/max_new or "
                    "serve with overflow='trim'")
            if budget < 1:
                raise ValueError(
                    f"request {req.rid}: max_new ({req.max_new}) leaves no "
                    f"room for any prompt token within max_len "
                    f"({self.max_len}) — cannot trim")
            req.prompt = req.prompt[-budget:]
        req.arrival_tick = self.ticks
        req.arrival_s = time.time()
        req._seq = self._submit_seq          # FIFO tiebreak under "cost"
        self._submit_seq += 1
        self.queue.append(req)

    def _admission_cost(self, req: Request) -> float:
        """Cost-model admission key: prompt length minus an aging credit,
        so queue time eventually dominates any length gap."""
        age = self.ticks - (req.arrival_tick or 0)
        return float(len(req.prompt)) - self.aging * age

    def _admit(self):
        for i in range(self.batch):
            if self.slots[i] is not None or not self.queue:
                continue
            if self.admission == "cost":
                j = min(range(len(self.queue)),
                        key=lambda j: (self._admission_cost(self.queue[j]),
                                       self.queue[j]._seq))
            else:
                j = 0
            req = self.queue.pop(j)
            self.slots[i] = req
            self.remaining_prompt[i] = np.asarray(req.prompt, np.int32)
            if self._fresh is None:
                self._fresh = M.init_cache(self.cfg, self.batch,
                                           self.max_len, device=self.device)
            M.reset_slot(self.cfg, self.cache, self._fresh, i)

    def _decode_tick(self, rows: list[int]):
        toks = np.zeros((self.batch, 1), np.int32)
        fed_prompt = [False] * self.batch
        active = [False] * self.batch
        for i in rows:
            req = self.slots[i]
            active[i] = True
            if self.remaining_prompt[i].size:       # prompt-feeding phase
                toks[i, 0] = self.remaining_prompt[i][0]
                self.remaining_prompt[i] = self.remaining_prompt[i][1:]
                fed_prompt[i] = True
            elif req.out:
                toks[i, 0] = req.out[-1]
            else:
                toks[i, 0] = req.prompt[-1]
        inputs = torch.from_numpy(toks).to(self.device)
        mask = torch.tensor(active, device=self.device)
        if self.use_mcma_dispatch:
            logits, self.cache, m = self.decode(self.params, self.cache,
                                                inputs, mask)
            # a family without an ApproxFFN (xLSTM) reports no metrics
            if "invocation" in m:
                n_active = sum(active)
                self.invocation_sum += float(m["invocation"]) * n_active
                self.active_sum += n_active
            if "dropped_rows" in m:
                self.dropped_sum += float(m["dropped_rows"])
                disp = m["dispatched"].double().cpu().numpy()
                routed = m["class_counts"].double().cpu().numpy()
                self.dispatched_sum = disp if self.dispatched_sum is None \
                    else self.dispatched_sum + disp
                self.routed_sum = routed if self.routed_sum is None \
                    else self.routed_sum + routed
        else:
            logits, self.cache = self.decode(self.params, self.cache,
                                             inputs, mask)
        if self.greedy:
            nxt = torch.argmax(logits, -1)
        else:
            probs = torch.softmax(logits.float(), -1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        nxt = nxt.cpu().numpy()
        pos = self.cache["pos"].cpu().numpy()
        now = None
        for i in rows:
            req = self.slots[i]
            if fed_prompt[i] and self.remaining_prompt[i].size:
                continue                              # still consuming prompt
            req.out.append(int(nxt[i]))
            if req.first_token_tick is None:
                req.first_token_tick = self.ticks + 1
                now = time.time() if now is None else now
                req.first_token_s = now
            if (self.eos is not None and req.out[-1] == self.eos) \
                    or len(req.out) >= req.max_new \
                    or int(pos[i]) >= self.max_len - 1:
                req.done = True
                self.slots[i] = None

    def tick(self):
        """One scheduler tick: admit, then run one decode step over the
        occupied slots."""
        self._admit()
        rows = [i for i, s in enumerate(self.slots) if s is not None]
        if not rows:
            return False
        self._decode_tick(rows)
        self.ticks += 1
        return True

    def run_until_drained(self, max_ticks: int = 10_000) -> DrainStats:
        """Tick until queue and slots are empty (or ``max_ticks``); returns
        a ``DrainStats``.  Requests stranded by ``max_ticks`` are marked
        aborted and counted."""
        t0 = time.time()
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.ticks < max_ticks:
            self.tick()
        stats = DrainStats(ticks=self.ticks, wall_s=time.time() - t0)
        stats.undrained_inflight = sum(s is not None for s in self.slots)
        for i, s in enumerate(self.slots):
            if s is not None:
                s.aborted = True
                self.slots[i] = None
                self.remaining_prompt[i] = np.zeros((0,), np.int32)
        for r in self.queue:
            r.aborted = True
        stats.undrained_queued = len(self.queue)
        if self.use_mcma_dispatch:
            stats.invocation_rate = \
                self.invocation_sum / max(self.active_sum, 1)
            stats.dropped_rows = self.dropped_sum
            if self.routed_sum is not None:
                stats.routed_per_class = self.routed_sum.tolist()
                stats.dispatched_per_class = self.dispatched_sum.tolist()
                total = max(float(self.routed_sum.sum()), 1.0)
                stats.dropped_frac = self.dropped_sum / total
                stats.served_invocation_rate = \
                    float(self.dispatched_sum[1:].sum()) / total
        stats.kv_bytes_resident = self._kv_bytes_resident()
        return stats

    def _kv_bytes_resident(self) -> int:
        """Resident KV-cache bytes: the dense cache reserves batch x
        max_len for k and v whatever is held; a pure-SSM cache holds no
        KV."""
        k = self.cache.get("k")
        if k is None:
            return 0
        return 2 * k.numel() * k.element_size()
