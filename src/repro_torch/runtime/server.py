"""Batched decode server loop (counterpart of ``repro/runtime/server.py``).

Continuous batching over a fixed-size slot table (``batch`` concurrent
sequences): finished sequences (EOS, ``max_new`` or ``max_len``) free
their slot, and queued requests fill freed slots each tick, admitted by a
cost model (prompt length, or pages on a paged cache, minus an aging
credit) or in FIFO order.

Prefill is CHUNKED when ``prefill_chunk`` = S > 0: a slot consumes its
prompt S tokens per tick through the (B, S) chunk step
(steps.make_prefill_chunk_step) into the decode cache, and the scheduler
alternates prefill ticks with decode ticks while both have work.  Only
the final prompt token goes through the decode step, so the first
sampled token comes from the same decode step as in token-by-token
serving (``prefill_chunk=0``).  The xLSTM family cannot address its
state positionally and feeds its prompts token by token whatever
``prefill_chunk``.

The ``max_len`` contract: positions are absolute, never recycled.
``submit()`` enforces ``len(prompt) + max_new <= max_len`` loudly (or
trims the prompt's HEAD under ``overflow="trim"``), and the tick loop
aborts, never clamp-writes, a slot whose prompt cannot fit.

The KV cache is dense ``(batch, max_len)`` by default, or PAGED when
``kv_page_size > 0``: a pool of ``kv_pages`` pages of ``kv_page_size``
tokens plus a per-slot block table.  The host allocator here hands pages
to a slot as its ``pos`` crosses page boundaries and takes them all back
when its request finishes, aborts or strands; admission reserves each
request's worst-case page count up front, so growth in flight can never
run the pool dry, and the cost model prices pages.  ``route_scope="tick"``
routes once per tick (models/approx_ffn.make_tick_plan).

The server runs where its parameters live.  The xLSTM family has no KV
cache and no ApproxFFN (``--mcma-dispatch`` runs report invocation rate
0).  Options of features not ported yet raise ``NotImplementedError``
naming the ROADMAP item that ports them: QoS tiers (``qos_tiers``,
``qos_app``; item 6b), library residency and autotune (``library``,
``autotune``; item 6c) and the mesh (``mesh``; item 10).
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
    "autotune": "item 6c (runtime/autotune.py)",
    "qos_tiers": "item 6b (QoS tiers, with apps/ from item 4)",
    "qos_app": "item 6b (QoS tiers, with apps/ from item 4)",
    "library": "item 6c (library residency)",
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
    prefill_ticks: int = 0
    prefill_tokens: int = 0
    invocation_rate: Optional[float] = None
    prefill_invocation_rate: Optional[float] = None
    dropped_rows: Optional[float] = None
    routed_per_class: Optional[list] = None
    dispatched_per_class: Optional[list] = None
    dropped_frac: Optional[float] = None
    served_invocation_rate: Optional[float] = None
    # paged KV cache (kv_page_size > 0) only
    pages_in_use: Optional[int] = None     # pages held at drain end
    page_hwm: Optional[int] = None         # peak pages held
    alloc_failures: Optional[int] = None   # admission deferrals under pool
                                           # pressure + pool-exhaust aborts
    page_util: Optional[float] = None      # held tokens / (held pages x
                                           # page_size), tick-meaned
    # peak resident KV bytes: a dense cache's (constant) worst case, a
    # paged run's page_hwm pages
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


def _check_ported(o: ServeOptions):
    default = ServeOptions()
    for name, item in _UNPORTED.items():
        if getattr(o, name) != getattr(default, name):
            raise NotImplementedError(
                f"ServeOptions.{name}={getattr(o, name)!r} is not ported "
                f"yet: ROADMAP queue 1, {item}")


class DecodeServer:
    def __init__(self, cfg: ModelConfig, params: M.Model, *,
                 options: ServeOptions | None = None):
        """``DecodeServer(cfg, params, options=ServeOptions(...))``: serve
        ``params`` (a ``models.model.Model``) on the device it lives on."""
        o = self.options = options if options is not None else ServeOptions()
        _check_ported(o)
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
        # chunked prefill needs a positionally addressed KV cache; the
        # xLSTM family feeds its prompts token by token whatever is asked
        self.chunkable = M.topology(cfg).kind == "uniform" \
            and not cfg.sliding_window
        self.prefill_chunk = int(o.prefill_chunk) if self.chunkable else 0
        assert self.prefill_chunk >= 0, o.prefill_chunk
        # paged KV cache: the host allocator owns the per-slot block table
        # (_bt, copied to the cache's block_table before a step when it
        # changed); pages are taken lazily as a slot's pos crosses a page
        # boundary and all returned when its request ends; admission
        # reserves ceil((prompt + max_new) / page_size) pages up front
        self.page_size = int(o.kv_page_size)
        self.n_pages = 0
        if self.page_size:
            assert self.chunkable, (
                "paged KV caches need the uniform dense-attention family "
                f"(got family={cfg.family!r})")
            assert self.max_len % self.page_size == 0, (
                f"kv_page_size={self.page_size} must divide "
                f"max_len={self.max_len}: the gathered page view must keep "
                "the dense reduction shape")
            self.pages_per_slot = self.max_len // self.page_size
            self.n_pages = int(o.kv_pages) or self.batch * self.pages_per_slot
            assert self.n_pages >= 1, o.kv_pages
            self._free_pages = list(range(self.n_pages))
            self._slot_pages: list[list[int]] = [[] for _ in
                                                 range(self.batch)]
            self._bt = np.full((self.batch, self.pages_per_slot), -1,
                               np.int32)
            self._bt_dirty = False
            self._reserved = [0] * self.batch   # worst-case pages per slot
            self._reserved_total = 0
            self._held_token_ticks = 0          # sum over ticks of tokens
            self._held_page_ticks = 0           # sum over ticks of pages
        self.pages_in_use = 0
        self.page_hwm = 0
        self.alloc_failures = 0
        # host mirror of cache["pos"] for the occupied slots: it drives page
        # acquisition and the unservable-prompt guard without a device
        # read, and is pinned against the device after every decode tick
        self._pos_host = np.zeros((self.batch,), np.int64)
        step_kw = dict(use_mcma_dispatch=self.use_mcma_dispatch,
                       with_stats=self.use_mcma_dispatch,
                       route_scope=self.route_scope, backend=self.backend)
        self.decode = steps_lib.make_decode_step(cfg, **step_kw)
        self.chunk = steps_lib.make_prefill_chunk_step(cfg, **step_kw) \
            if self.prefill_chunk else None
        self.invocation_sum = 0.0    # active-slot-weighted invocation sum
        self.active_sum = 0          # total active slots over all ticks
        self.dropped_sum = 0.0       # dropped rows over decode ticks
        self.dispatched_sum = None   # (n+1,) dispatched rows, decode ticks
        self.routed_sum = None       # (n+1,) routed rows, decode ticks
        # prefill-chunk dispatch stats are kept apart: the invocation rate
        # above is the decode-phase signal
        self.prefill_invocation_sum = 0.0   # token-weighted, chunk ticks
        self.prefill_tokens = 0             # real prompt tokens chunked
        self.prefill_ticks = 0
        # bounded per-tick trace: (phase, tokens processed, invocation or
        # None)
        self.tick_log: list[tuple] = []
        self.tick_log_cap = 4096
        self.cache = M.init_cache(cfg, self.batch, self.max_len,
                                  page_size=self.page_size,
                                  kv_pages=self.n_pages, device=self.device)
        self.slots: list[Request | None] = [None] * self.batch
        self.queue: list[Request] = []
        self.remaining_prompt: list[np.ndarray] = \
            [np.zeros((0,), np.int32)] * self.batch
        self.ticks = 0
        self._fresh = None  # lazily-built pristine cache for slot resets
        self._phase_flip = False  # alternates prefill/decode when both ready
        self._submit_seq = 0

    def submit(self, req: Request):
        """Queue a request; per-request limits are validated HERE, loudly.

        The prompt must be non-empty and ``len(prompt) + max_new <=
        max_len`` must hold; overlong prompts raise under
        ``overflow="reject"`` or keep their LAST ``max_len - max_new``
        tokens under ``overflow="trim"``.  On a paged cache a request
        whose worst case needs more pages than the pool holds raises."""
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
                "tiers are not ported yet: ROADMAP queue 1, item 6b")
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
        if self.page_size:
            need = self._pages_needed(req.prompt.size + int(req.max_new))
            if need > self.n_pages:
                raise ValueError(
                    f"request {req.rid}: prompt ({req.prompt.size} tokens) "
                    f"+ max_new ({req.max_new}) needs {need} KV pages but "
                    f"the pool holds only {self.n_pages} "
                    f"(kv_page_size={self.page_size}); the request could "
                    "never be scheduled: raise kv_pages or shorten it")
        req.arrival_tick = self.ticks
        req.arrival_s = time.time()
        req._seq = self._submit_seq          # FIFO tiebreak under "cost"
        self._submit_seq += 1
        self.queue.append(req)

    def _admission_cost(self, req: Request) -> float:
        """Cost-model admission key: the request's appetite for what
        constrains the server (prompt length on a dense cache, the
        worst-case page count on a paged one) minus an aging credit, so
        queue time eventually dominates any gap."""
        age = self.ticks - (req.arrival_tick or 0)
        work = float(self._pages_needed(req.prompt.size + int(req.max_new))) \
            if self.page_size else float(len(req.prompt))
        return work - self.aging * age

    def _pages_needed(self, tokens: int) -> int:
        """Worst-case page count for ``tokens`` cache positions."""
        return (int(tokens) + self.page_size - 1) // self.page_size

    def _ensure_slot_pages(self, i: int, tokens: int):
        """Grow slot ``i``'s block table to cover ``tokens`` positions from
        the free pool.  Admission reserved the worst case, so the pool
        cannot run dry here; if it does, a scheduling invariant broke and
        this raises rather than drop a live token's write."""
        need = self._pages_needed(tokens)
        held = self._slot_pages[i]
        while len(held) < need:
            if not self._free_pages:
                self.alloc_failures += 1
                raise RuntimeError(
                    f"KV page pool exhausted growing slot {i} to {tokens} "
                    f"tokens (needs {need} pages; {self.pages_in_use}/"
                    f"{self.n_pages} in use): admission reservations "
                    "should make this unreachable")
            pg = self._free_pages.pop()
            self._bt[i, len(held)] = pg
            self._bt_dirty = True
            held.append(pg)
            self.pages_in_use += 1
            self.page_hwm = max(self.page_hwm, self.pages_in_use)

    def _release_slot(self, i: int):
        """Return slot ``i``'s pages to the pool and drop its reservation,
        the moment its request finishes, aborts or strands."""
        if not self.page_size:
            return
        self._free_pages.extend(self._slot_pages[i])
        self.pages_in_use -= len(self._slot_pages[i])
        self._slot_pages[i] = []
        self._bt[i, :] = -1
        self._bt_dirty = True
        self._reserved_total -= self._reserved[i]
        self._reserved[i] = 0
        self._pos_host[i] = 0

    def _sync_block_table(self):
        """Copy the allocator's block table into the cache's, in place,
        when it changed since the last step (same shape every tick)."""
        if self.page_size and self._bt_dirty:
            self.cache["block_table"].copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False

    def _admit(self):
        for i in range(self.batch):
            while self.slots[i] is None and self.queue:
                if self.admission == "cost":
                    j = min(range(len(self.queue)),
                            key=lambda j: (self._admission_cost(
                                self.queue[j]), getattr(self.queue[j],
                                                        "_seq", j)))
                else:
                    j = 0
                req = self.queue[j]
                need = 0
                if self.page_size:
                    need = self._pages_needed(
                        req.prompt.size + int(req.max_new))
                    if need > self.n_pages:
                        # can never fit the pool (injected past submit()):
                        # abort instead of wedging the queue's head
                        self.queue.pop(j)
                        req.aborted = True
                        req.done = True
                        continue
                    if self._reserved_total + need > self.n_pages:
                        # the worst case does not fit now: head-of-line
                        # block until in-flight requests free pages
                        self.alloc_failures += 1
                        return
                self.queue.pop(j)
                self.slots[i] = req
                self.remaining_prompt[i] = np.asarray(req.prompt, np.int32)
                if self.page_size:
                    self._reserved[i] = need
                    self._reserved_total += need
                if self._fresh is None:
                    self._fresh = M.init_cache(
                        self.cfg, self.batch, self.max_len,
                        page_size=self.page_size, kv_pages=self.n_pages,
                        device=self.device)
                M.reset_slot(self.cfg, self.cache, self._fresh, i)
                self._pos_host[i] = 0
                break

    def _abort_unservable(self):
        """Abort (never clamp-write) any slot whose remaining prompt cannot
        fit the cache: unreachable through submit(), this catches requests
        injected straight into ``queue``/``slots``."""
        for i, req in enumerate(self.slots):
            if req is None or not self.remaining_prompt[i].size:
                continue
            if int(self._pos_host[i]) + self.remaining_prompt[i].size \
                    > self.max_len:
                req.aborted = True
                req.done = True
                self.slots[i] = None
                self.remaining_prompt[i] = np.zeros((0,), np.int32)
                self._release_slot(i)

    def _prefill_rows(self) -> list[int]:
        """Slots mid-prompt with more than the final token left: the chunk
        step's work list (the last token always decodes)."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and self.remaining_prompt[i].size > 1]

    def _prefill_tick(self, rows: list[int]):
        """One chunked-prefill tick: up to S prompt tokens per listed slot
        into the decode cache; no logits, no sampling.  Other slots have
        n_valid 0: nothing is written for them and their ``pos`` holds."""
        S = self.prefill_chunk
        toks = np.zeros((self.batch, S), np.int32)
        nv = np.zeros((self.batch,), np.int32)
        for i in rows:
            n = min(S, self.remaining_prompt[i].size - 1)
            toks[i, :n] = self.remaining_prompt[i][:n]
            self.remaining_prompt[i] = self.remaining_prompt[i][n:]
            nv[i] = n
        if self.page_size:
            for i in rows:
                self._ensure_slot_pages(i, int(self._pos_host[i])
                                        + int(nv[i]))
            self._sync_block_table()
        self.cache, m = self.chunk(self.params, self.cache,
                                   torch.from_numpy(toks).to(self.device),
                                   torch.from_numpy(nv).to(self.device))
        self._pos_host += nv
        tokens = int(nv.sum())
        inv = None
        if "invocation" in m:
            inv = float(m["invocation"])
            self.prefill_invocation_sum += inv * tokens
        self.prefill_tokens += tokens
        self.prefill_ticks += 1
        self._log_tick("prefill", tokens, inv)

    def _decode_tick(self, rows: list[int]):
        """One decode tick for the listed slots; every other slot is
        masked out (its ``pos`` holds; its dummy write is overwritten by
        its next real token)."""
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
        if self.page_size:
            # each listed row writes one token at its pos this tick
            for i in rows:
                self._ensure_slot_pages(i, int(self._pos_host[i]) + 1)
            self._sync_block_table()
        inputs = torch.from_numpy(toks).to(self.device)
        mask = torch.tensor(active, device=self.device)
        n_active = sum(active)
        inv = None
        if self.use_mcma_dispatch:
            logits, self.cache, m = self.decode(self.params, self.cache,
                                                inputs, mask)
            # a family without an ApproxFFN (xLSTM) reports no metrics
            if "invocation" in m:
                inv = float(m["invocation"])
                self.invocation_sum += inv * n_active
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
        self._log_tick("decode", n_active, inv)
        if self.greedy:
            nxt = torch.argmax(logits, -1)
        else:
            probs = torch.softmax(logits.float(), -1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        nxt = nxt.cpu().numpy()
        pos = self.cache["pos"].cpu().numpy()
        for i in rows:
            self._pos_host[i] += 1
            # the mirror drives page acquisition: pin it to the device
            assert int(pos[i]) == int(self._pos_host[i]), \
                (i, int(pos[i]), int(self._pos_host[i]))
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
                self._release_slot(i)

    def _log_tick(self, phase: str, tokens: int, invocation):
        self.tick_log.append((phase, tokens, invocation))
        if len(self.tick_log) > self.tick_log_cap:
            del self.tick_log[0]

    def tick(self):
        """One scheduler tick: admit, then run ONE step, a prefill chunk
        or a decode step.  When both phases have work they alternate, so
        queued prompts load S tokens per prefill tick while in-flight
        decodes keep streaming."""
        self._admit()
        self._abort_unservable()
        if not any(s is not None for s in self.slots):
            return False
        prefill_rows = self._prefill_rows() if self.prefill_chunk else []
        decode_rows = [i for i, s in enumerate(self.slots)
                       if s is not None and i not in prefill_rows]
        if prefill_rows and (not decode_rows or not self._phase_flip):
            self._phase_flip = True
            self._prefill_tick(prefill_rows)
        else:
            self._phase_flip = False
            self._decode_tick(decode_rows)
        self.ticks += 1
        if self.page_size:
            # page_util's raw signal: tokens held vs the token capacity of
            # the pages holding them, once per tick
            self._held_token_ticks += int(sum(
                self._pos_host[i] for i in range(self.batch)
                if self._slot_pages[i]))
            self._held_page_ticks += self.pages_in_use
        return True

    def run_until_drained(self, max_ticks: int = 10_000) -> DrainStats:
        """Tick until queue and slots are empty (or ``max_ticks``); returns
        a ``DrainStats``.  Requests stranded by ``max_ticks`` are marked
        aborted and counted, and their pages returned."""
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
                self._release_slot(i)
        for r in self.queue:
            r.aborted = True
        stats.undrained_queued = len(self.queue)
        stats.prefill_ticks = self.prefill_ticks
        stats.prefill_tokens = self.prefill_tokens
        if self.use_mcma_dispatch:
            stats.invocation_rate = \
                self.invocation_sum / max(self.active_sum, 1)
            if self.prefill_tokens:
                stats.prefill_invocation_rate = \
                    self.prefill_invocation_sum / self.prefill_tokens
            stats.dropped_rows = self.dropped_sum
            if self.routed_sum is not None:
                stats.routed_per_class = self.routed_sum.tolist()
                stats.dispatched_per_class = self.dispatched_sum.tolist()
                total = max(float(self.routed_sum.sum()), 1.0)
                stats.dropped_frac = self.dropped_sum / total
                stats.served_invocation_rate = \
                    float(self.dispatched_sum[1:].sum()) / total
        if self.page_size:
            stats.pages_in_use = self.pages_in_use
            stats.page_hwm = self.page_hwm
            stats.alloc_failures = self.alloc_failures
            stats.page_util = self._held_token_ticks / max(
                self._held_page_ticks * self.page_size, 1)
        stats.kv_bytes_resident = self._kv_bytes_resident()
        return stats

    def _kv_bytes_resident(self) -> int:
        """Peak resident KV-cache bytes: a dense cache reserves batch x
        max_len for k and v whatever is held; a paged run pays for the
        pages of its high-water mark (the trash page is not counted); a
        pure-SSM cache holds no KV."""
        k = self.cache.get("k")
        if k is None:
            return 0
        if not self.page_size:
            return 2 * k.numel() * k.element_size()
        per_page = 2 * k[:, 0].numel() * k.element_size()
        return per_page * self.page_hwm
