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
serving (``prefill_chunk=0``).  The xLSTM and hybrid (zamba2) families
cannot address their recurrent state positionally and feed their prompts
token by token whatever ``prefill_chunk``.

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

Per-request QoS (``qos_tiers``, ``qos_app``): a table of ascending
error bounds, each with an exact-logit router margin
(runtime/autotune.margins_from_bounds); ``submit`` snaps a request's
``error_bound`` onto the table (or takes its ``tier``), the tier vector
and the margins ride into every step as tensors, cost admission weighs
tight tiers more, and the drain summary carries the ``per_tier`` ledger.
An approximator library (``library``, a ``LibrarySpec``): the checkpoint
holds ``library_size`` approximators, ``n_resident`` of them serve at a
time, and a ``ResidencyController`` fed each decode tick's full-library
demand (``lib_counts``) swaps the resident set, a new residency vector
through the same step objects.  Capacity autotune (``autotune``): a
``CapacityController`` walks a ladder of operating points from each
decode tick's routed counts and dropped rows; each rung has its own
decode and chunk step, built on first use and cached.  The controllers
read each decode tick's counts on the host: one device read a tick,
with the sampled tokens and ``pos``.

The server runs where its parameters live.  The xLSTM family has no KV
cache and no ApproxFFN (``--mcma-dispatch`` runs report invocation rate
0); the hybrid's KV cache holds the shared block's k/v of each group and
its ApproxFFN is the shared block's.  The MoE family serves its MoE in
every block (``use_mcma_dispatch`` changes nothing there: no ApproxFFN,
no invocation rate); a sliding-window model (mixtral-8x7b) keeps a
ring buffer of the window and takes neither chunked prefill nor a paged
cache.  The server feeds token ids, so an
architecture that takes embeddings (``input_mode="embeddings"``) is
refused.

``mesh`` (a ``launch/mesh.HostMesh``) serves every family SPMD, one
process per rank: every rank runs this same host loop on the same
submitted requests (admission, the page allocator and the tier table are
deterministic and replicated), holds only its shard of the parameters
(``_shard_params``: sliced by ``sharding/rules.param_pspecs``, the full
copy freed; parameters drawn as shards, ``model.init_model(mesh=)``,
are kept) and of the cache, and runs every step under
``steps.serve_mesh_context``: each data shard dispatches its own rows at
per-shard capacities, the exact FFN and attention run tensor-parallel
over "model" (attention below one kv head a rank over a head_dim-split
cache; an MoE's experts expert-parallel, each model rank its E /
|model|, routing per data shard at per-shard capacities, or with fewer
experts than ranks each expert's d_ff split, routed as one device; the
Mamba2,
mLSTM and sLSTM blocks by heads, each rank holding its rows' and heads'
recurrent state; with fewer xLSTM heads than model ranks every head's
state whole), and the logits and invoke stats come back gathered
and all-reduced, so the sampled tokens and what the controllers read
are bitwise equal on every rank.  A slot table that does not divide over
the data axes is whole on every data rank (each dispatches every slot as
one device, at one device's capacities, stats counted once; a dense or
ring KV cache split over the data ranks by sequence, whose length must
then divide over them).  A mesh that does not divide the model raises
(``model.check_mesh_servable``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.runtime import autotune as at
from repro_torch.runtime import steps as steps_lib
from repro_torch.runtime.options import ServeOptions
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R


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
    per_tier: Optional[list] = None
    autotune: Optional[dict] = None
    # approximator-library residency (LibrarySpec deployments only)
    lib_routed_per_class: Optional[list] = None   # (library_size + 1,)
    off_set_exact_rows: Optional[float] = None    # off-set, served exact
    residency: Optional[dict] = None              # the controller's summary
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


def to_host(named: dict) -> dict:
    """Named device tensors as numpy arrays of their shapes, in ONE
    device read: gathered into one float64 vector (token ids, positions
    and float32 counts are all exact in float64) and split back."""
    parts = list(named.values())
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in parts]).cpu().numpy()
    out, i = {}, 0
    for k, t in zip(named, parts):
        out[k] = flat[i:i + t.numel()].reshape(t.shape)
        i += t.numel()
    return out


class DecodeServer:
    def __init__(self, cfg: ModelConfig, params: M.Model, *,
                 options: ServeOptions | None = None):
        """``DecodeServer(cfg, params, options=ServeOptions(...))``: serve
        ``params`` (a ``models.model.Model``) on the device it lives on.
        With ``options.mesh`` the server takes ``params`` over: each
        parameter's storage becomes this rank's shard (a model too large
        for one device is drawn as shards: ``model.init_model(mesh=)``)."""
        o = self.options = options if options is not None else ServeOptions()
        self.mesh = o.mesh
        if self.mesh is not None:
            M.check_mesh_servable(cfg, self.mesh, o.batch,
                                  max_len=o.max_len,
                                  paged=bool(o.kv_page_size))
        if cfg.input_mode != "tokens":
            raise ValueError(f"{cfg.name} takes embeddings (input_mode="
                             f"{cfg.input_mode!r}); the server feeds token "
                             "ids")
        if o.admission not in ("cost", "fifo"):
            raise ValueError(f"unknown admission policy: {o.admission!r} "
                             "(expected 'cost' or 'fifo')")
        if o.overflow not in ("reject", "trim"):
            raise ValueError(f"unknown overflow policy: {o.overflow!r} "
                             "(expected 'reject' or 'trim')")
        self.cfg, self.params = cfg, params
        self.device = next(params.parameters()).device
        if self.mesh is not None:
            self._shard_params(params)
        cfg = self._setup_qos(cfg, o)
        cfg = self._setup_library(cfg, o)
        self.cfg = cfg
        self.batch, self.max_len, self.eos = o.batch, o.max_len, o.eos
        self.greedy = o.greedy
        self.gen = torch.Generator(device=self.device).manual_seed(o.seed)
        self.use_mcma_dispatch = o.use_mcma_dispatch
        self.backend = o.backend
        self.route_scope = o.route_scope
        self.admission, self.aging, self.overflow = \
            o.admission, float(o.aging), o.overflow
        # chunked prefill needs a positionally addressed KV cache; the
        # xLSTM and hybrid families and sliding-window ring buffers feed
        # their prompts token by token whatever is asked
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
                f"(got family={cfg.family!r}, "
                f"sliding_window={cfg.sliding_window})")
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
        self.controller = self._make_controller(cfg, o)
        # the decode-tick metrics read on the host (_read_tick)
        self._tick_metrics = ("invocation", "dropped_rows", "dispatched",
                              "class_counts")
        if self.tier_bounds is not None:
            self._tick_metrics += ("tier_counts", "tier_dispatched")
        if self.residency_controller is not None:
            self._tick_metrics += ("lib_counts", "off_set_exact_rows")
        # every step object built, as (kind, operating point): what
        # analysis/jit_cache.cache_size counts (one per rung served)
        self.step_builds: list[tuple[str, object]] = []
        self._steps = {}             # ladder index -> decode step
        self._chunk_steps = {}       # ladder index -> chunk step
        self.decode = self._make_step(None)
        self.chunk = self._make_chunk_step(None) if self.prefill_chunk \
            else None
        self.invocation_sum = 0.0    # active-slot-weighted invocation sum
        self.active_sum = 0          # total active slots over all ticks
        self.dropped_sum = 0.0       # dropped rows over decode ticks
        self.dispatched_sum = None   # (n+1,) dispatched rows, decode ticks
        self.routed_sum = None       # (n+1,) routed rows, decode ticks
        self.routed_history = []     # per-tick (n+1,) routed counts, the
                                     # ladder_from_counts signal (bounded)
        self.routed_history_cap = 4096
        self.tier_routed_sum = None      # (n_tiers, n+1) per-tier routed
        self.tier_dispatched_sum = None  # (n_tiers, n+1) per-tier served
        self.lib_routed_sum = None       # (library_size+1,) library demand
        self.off_set_sum = 0.0           # rows routed to off-set library
                                         # classes (served exact)
        # prefill-chunk dispatch stats are kept apart: the invocation rate
        # above is the decode-phase signal
        self.prefill_invocation_sum = 0.0   # token-weighted, chunk ticks
        self.prefill_tokens = 0             # real prompt tokens chunked
        self.prefill_ticks = 0
        # bounded per-tick trace: (phase, tokens processed, invocation or
        # None)
        self.tick_log: list[tuple] = []
        self.tick_log_cap = 4096
        with self._mesh_ctx():
            self.cache = M.init_cache(cfg, self.batch, self.max_len,
                                      page_size=self.page_size,
                                      kv_pages=self.n_pages,
                                      device=self.device)
        self.slots: list[Request | None] = [None] * self.batch
        self.queue: list[Request] = []
        self.remaining_prompt: list[np.ndarray] = \
            [np.zeros((0,), np.int32)] * self.batch
        self.ticks = 0
        self._fresh = None  # lazily-built pristine cache for slot resets
        self._phase_flip = False  # alternates prefill/decode when both ready
        self._submit_seq = 0

    def _setup_qos(self, cfg: ModelConfig, o: ServeOptions) -> ModelConfig:
        """The QoS tier table: ``qos_tiers`` True takes the config's
        ``tier_bounds`` or the default (tight, base, loose) table around
        the base bound (the ``qos_app``'s registry bound, else the
        config's); a tuple of bounds is taken as given.  Each tier gets
        the exact-logit margin ``margins_from_bounds`` assigns it, a
        tensor input of every step.  Returns the config with the table."""
        self.tier_bounds = None
        self.qos_app = None
        qos_tiers = o.qos_tiers
        if o.qos_app is not None:
            from repro_torch.apps.registry import get_app
            self.qos_app = get_app(o.qos_app)
            if qos_tiers is None:
                qos_tiers = True
        if not qos_tiers:
            return cfg
        assert o.use_mcma_dispatch, \
            "per-request QoS tiers route through the dispatch engine; " \
            "needs use_mcma_dispatch"
        base = self.qos_app.error_bound if self.qos_app is not None \
            else cfg.approx.error_bound
        if qos_tiers is True:
            qos_tiers = cfg.approx.tier_bounds \
                or at.default_tier_bounds(base)
        self.tier_bounds = tuple(sorted(float(b) for b in qos_tiers))
        assert self.tier_bounds[0] > 0, self.tier_bounds
        self.tier_margins = np.asarray(
            at.margins_from_bounds(self.tier_bounds, base,
                                   scale=o.qos_margin_scale), np.float32)
        self._margins_dev = torch.from_numpy(self.tier_margins).to(
            self.device)
        # requests without a bound serve at the tier closest to the bound
        # the router was trained at
        self.default_tier = int(np.argmin(
            [abs(b - base) for b in self.tier_bounds]))
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, n_tiers=len(self.tier_bounds),
            tier_bounds=self.tier_bounds,
            tier_margins=tuple(float(m) for m in self.tier_margins)))

    def _setup_library(self, cfg: ModelConfig,
                       o: ServeOptions) -> ModelConfig:
        """Approximator-library residency: the checkpoint's full library
        stays in ``params``; the serving ``n_approx`` becomes the spec's
        resident-slot count (capacities and the ladder are per slot), and
        the ``ResidencyController`` starts from the spec's initial set."""
        self.library = o.library
        self.residency_controller = None
        self.residency = None
        if self.library is None:
            return cfg
        spec = self.library
        assert o.use_mcma_dispatch, \
            "library residency routes through the dispatch engine; " \
            "needs use_mcma_dispatch"
        assert cfg.approx.n_live == spec.library_size, (
            f"LibrarySpec.library_size={spec.library_size} must equal "
            f"the checkpoint's trained approximator count "
            f"(cfg.approx.n_live={cfg.approx.n_live})")
        assert not cfg.approx.invoke_fracs \
            or len(cfg.approx.invoke_fracs) == spec.n_resident, (
                "per-class invoke_fracs are per resident SLOT "
                f"(need {spec.n_resident}, got "
                f"{len(cfg.approx.invoke_fracs)})")
        self.residency_controller = at.ResidencyController(spec)
        self._set_residency(spec.initial_residency())
        return dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, n_approx=spec.n_resident,
            library_size=spec.library_size))

    def _set_residency(self, residency):
        """Adopt a resident set; its device copy is refreshed only when
        the set changed."""
        new = np.asarray(residency, np.int32)
        if self.residency is None or not np.array_equal(new,
                                                        self.residency):
            self._residency_dev = torch.from_numpy(new).to(self.device)
        self.residency = new

    def _make_controller(self, cfg: ModelConfig, o: ServeOptions):
        """The capacity controller over ``default_ladder(cfg)`` (or the
        given ladder), started at the static operating point when the
        ladder holds it, else at the cheapest rung."""
        if not o.autotune:
            return None
        assert o.use_mcma_dispatch, \
            "autotune consumes invoke_stats; needs use_mcma_dispatch"
        ladder = at.default_ladder(cfg) if o.autotune is True \
            else tuple(o.autotune)
        n = cfg.approx.n_approx
        base = at.OperatingPoint(cfg.approx.exact_frac,
                                 cfg.approx.invoke_frac,
                                 cfg.approx.shard_slack)
        kw = dict(o.autotune_kwargs or {})
        if "start" not in kw and base in ladder:
            kw["start"] = ladder.index(base)
        shards = self._dp_shards()
        return at.CapacityController(
            ladder, lambda pt: at.point_caps(pt, self.batch // shards, n,
                                             n_shards=shards),
            drop_budget=o.drop_budget, **kw)

    def _dp_shards(self) -> int:
        """The data shards the batch splits over (1 without a mesh, and
        where the batch does not divide over the data axes: every data
        rank then holds every slot)."""
        g = 1 if self.mesh is None else self.mesh.size(R.dp_axes(self.mesh))
        return g if self.batch % g == 0 else 1

    def _mesh_ctx(self):
        return steps_lib.serve_mesh_context(self.mesh)

    def _shard_params(self, params: M.Model):
        """Each parameter's storage replaced, in place, by this rank's
        block under ``sharding/rules.param_pspecs`` (its spec kept as
        ``_pspec`` for ``collectives.unshard``); the full copy is freed.
        A parameter that is a shard already stays as it is."""
        C.shard_params(self.mesh, params)

    def _step_kw(self, point) -> dict:
        return dict(use_mcma_dispatch=self.use_mcma_dispatch,
                    with_stats=self.use_mcma_dispatch, operating_point=point,
                    route_scope=self.route_scope, backend=self.backend)

    def _make_step(self, point):
        self.step_builds.append(("decode", point))
        return steps_lib.make_decode_step(self.cfg, **self._step_kw(point))

    def _make_chunk_step(self, point):
        self.step_builds.append(("chunk", point))
        return steps_lib.make_prefill_chunk_step(self.cfg,
                                                 **self._step_kw(point))

    def _active_step(self):
        """The decode step for this tick: the controller's current rung
        when autotuning (built on first use, then cached), else the
        static step."""
        if self.controller is None:
            return self.decode
        idx = self.controller.index
        if idx not in self._steps:
            self._steps[idx] = self._make_step(self.controller.ladder[idx])
        return self._steps[idx]

    def _active_chunk_step(self):
        """The chunk step at the decode step's rung (prefill runs at the
        same operating point; its stats never feed the controller)."""
        if self.controller is None:
            return self.chunk
        idx = self.controller.index
        if idx not in self._chunk_steps:
            self._chunk_steps[idx] = self._make_chunk_step(
                self.controller.ladder[idx])
        return self._chunk_steps[idx]

    def _step_inputs(self) -> dict:
        """The tick's tensor inputs beyond the tokens: the slots' tier
        vector and the margins (QoS), the residency vector (library)."""
        kw = {}
        if self.tier_bounds is not None:
            kw["tier"] = torch.from_numpy(self._tiers_arr()).to(self.device)
            kw["tier_margins"] = self._margins_dev
        if self.residency is not None:
            kw["residency"] = self._residency_dev
        return kw

    def _tiers_arr(self) -> np.ndarray:
        return np.asarray(
            [self.default_tier if s is None or s.tier is None
             else s.tier for s in self.slots], np.int32)

    def submit(self, req: Request):
        """Queue a request; per-request limits are validated HERE, loudly.

        The prompt must be non-empty and ``len(prompt) + max_new <=
        max_len`` must hold; overlong prompts raise under
        ``overflow="reject"`` or keep their LAST ``max_len - max_new``
        tokens under ``overflow="trim"``.  On a paged cache a request
        whose worst case needs more pages than the pool holds raises.

        ``req.error_bound`` is checked against the tier table (anchored
        on the registry app's bound under ``qos_app``): a bound tighter
        than the tightest tier, or not positive and finite, raises; a
        valid one snaps to the largest tier bound <= the request (served
        at or tighter than asked; looser than every tier clamps to the
        loosest).  ``req.tier`` picks a tier directly and must be in
        range.  Either on a server without a tier table raises."""
        req.prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if req.prompt.size == 0:
            raise ValueError(f"request {req.rid}: empty prompt — a request "
                             "must carry at least one prompt token")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new {req.max_new} "
                             "must be >= 1")
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
        self._validate_tier(req)
        req.arrival_tick = self.ticks
        req.arrival_s = time.time()
        req._seq = self._submit_seq          # FIFO tiebreak under "cost"
        self._submit_seq += 1
        self.queue.append(req)

    def _validate_tier(self, req: Request):
        """Snap ``req.error_bound`` onto the tier table, or range-check
        ``req.tier`` (``submit``'s QoS contract)."""
        if (req.error_bound is not None or req.tier is not None) \
                and self.tier_bounds is None:
            raise ValueError(
                f"request {req.rid} carries a QoS error_bound/tier but this "
                "server has no tier table: construct the DecodeServer with "
                "ServeOptions(qos_tiers=...) (or qos_app=...) to serve "
                "per-request quality")
        if req.error_bound is not None:
            eb = float(req.error_bound)
            lo = self.tier_bounds[0]
            app = f" (app '{self.qos_app.name}' registry quality bound " \
                  f"{self.qos_app.error_bound})" if self.qos_app else ""
            if not np.isfinite(eb) or eb <= 0.0:
                raise ValueError(f"request {req.rid}: error_bound {eb!r} "
                                 f"is not a positive finite relative "
                                 f"error{app}")
            if eb < lo - 1e-12:
                raise ValueError(
                    f"request {req.rid}: error_bound {eb} is tighter than "
                    f"the tightest served tier {lo}: out of range for "
                    f"tiers {self.tier_bounds}{app}")
            req.tier = max(i for i, b in enumerate(self.tier_bounds)
                           if b <= eb + 1e-12)
        elif req.tier is not None:
            if not 0 <= int(req.tier) < len(self.tier_bounds):
                raise ValueError(
                    f"request {req.rid}: tier {req.tier} out of range for "
                    f"{len(self.tier_bounds)} tiers {self.tier_bounds}")
            req.tier = int(req.tier)

    def _admission_cost(self, req: Request) -> float:
        """Cost-model admission key: the request's appetite for what
        constrains the server (prompt length on a dense cache, the
        worst-case page count on a paged one), scaled by its tier's (a
        tight tier routes more rows to the exact FFN: the tightest costs
        x1.5), minus an aging credit, so queue time eventually dominates
        any gap."""
        mult = 1.0
        if self.tier_bounds is not None and len(self.tier_bounds) > 1:
            tier = req.tier if req.tier is not None else self.default_tier
            n = len(self.tier_bounds)
            mult = 1.0 + 0.5 * (n - 1 - tier) / (n - 1)
        age = self.ticks - (req.arrival_tick or 0)
        work = float(self._pages_needed(req.prompt.size + int(req.max_new))) \
            if self.page_size else float(len(req.prompt))
        return work * mult - self.aging * age

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
            bt = self._bt
            if self.mesh is not None:          # this data shard's rows
                bt = bt[C.local_rows(self.mesh, R.dp_axes(self.mesh),
                                     self.batch)]
            self.cache["block_table"].copy_(torch.from_numpy(bt))
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
                with self._mesh_ctx():
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
        with self._mesh_ctx():
            self.cache, m = self._active_chunk_step()(
                self.params, self.cache,
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(nv).to(self.device), **self._step_inputs())
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
        with self._mesh_ctx():
            if self.use_mcma_dispatch:
                logits, self.cache, m = self._active_step()(
                    self.params, self.cache, inputs, mask,
                    **self._step_inputs())
            else:
                logits, self.cache = self.decode(self.params, self.cache,
                                                 inputs, mask)
                m = {}
        if self.greedy:
            nxt = torch.argmax(logits, -1)
        else:
            probs = torch.softmax(logits.float(), -1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        host = self._read_tick(m, nxt, self.cache["pos"])
        nxt, pos = host["next"].astype(np.int64), \
            host["pos"].astype(np.int64)
        inv = None
        # a family without an ApproxFFN (xLSTM) reports no metrics; the
        # hybrid's are its shared block's
        if "invocation" in host:
            inv = float(host["invocation"])
            self.invocation_sum += inv * n_active
            self.active_sum += n_active
        if "dropped_rows" in host:
            self._observe_decode(host)
        self._log_tick("decode", n_active, inv)
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

    def _read_tick(self, m: dict, nxt: torch.Tensor,
                   pos: torch.Tensor) -> dict:
        """The decode tick's one device read: the sampled tokens, ``pos``
        and the metrics the server and its controllers consume."""
        return to_host({"next": nxt, "pos": pos,
                        **{k: m[k] for k in self._tick_metrics if k in m}})

    def _observe_decode(self, host: dict):
        """Accumulate a decode tick's dispatch stats, the QoS ledger and
        the library demand, and feed the controllers: the capacity
        controller picks the next tick's rung, the residency controller
        the next tick's resident set."""
        dropped = float(host["dropped_rows"])
        disp, routed = host["dispatched"], host["class_counts"]
        self.dropped_sum += dropped
        self.dispatched_sum = disp if self.dispatched_sum is None \
            else self.dispatched_sum + disp
        self.routed_sum = routed if self.routed_sum is None \
            else self.routed_sum + routed
        self.routed_history.append(routed)
        if len(self.routed_history) > self.routed_history_cap:
            del self.routed_history[0]
        if "tier_counts" in host:
            tc, td = host["tier_counts"], host["tier_dispatched"]
            self.tier_routed_sum = tc if self.tier_routed_sum is None \
                else self.tier_routed_sum + tc
            self.tier_dispatched_sum = td \
                if self.tier_dispatched_sum is None \
                else self.tier_dispatched_sum + td
        if self.controller is not None:
            self.controller.observe({"class_counts": routed,
                                     "dropped": dropped})
        if self.residency_controller is not None and "lib_counts" in host:
            lib = host["lib_counts"]
            self.lib_routed_sum = lib if self.lib_routed_sum is None \
                else self.lib_routed_sum + lib
            self.off_set_sum += float(host["off_set_exact_rows"])
            self._set_residency(self.residency_controller.observe(
                {"lib_counts": lib}))

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
            if self.tier_bounds is not None \
                    and self.tier_routed_sum is not None:
                stats.per_tier = self._per_tier()
            if self.lib_routed_sum is not None:
                # full-library demand against what the resident set could
                # serve: off-set rows were served exact
                stats.lib_routed_per_class = self.lib_routed_sum.tolist()
                stats.off_set_exact_rows = self.off_set_sum
        if self.controller is not None:
            stats.autotune = self.controller.summary()
        if self.residency_controller is not None:
            stats.residency = self.residency_controller.summary()
        if self.page_size:
            stats.pages_in_use = self.pages_in_use
            stats.page_hwm = self.page_hwm
            stats.alloc_failures = self.alloc_failures
            stats.page_util = self._held_token_ticks / max(
                self._held_page_ticks * self.page_size, 1)
        stats.kv_bytes_resident = self._kv_bytes_resident()
        return stats

    def _per_tier(self) -> list:
        """The drain summary's QoS ledger: routed rows, served and routed
        invocation and dropped rows attributed to each error-bound tier."""
        per = []
        for k, bound in enumerate(self.tier_bounds):
            routed_k = self.tier_routed_sum[k]
            disp_k = self.tier_dispatched_sum[k]
            rows = float(routed_k.sum())
            dropped = float((routed_k - disp_k).sum())
            per.append({
                "tier": k,
                "error_bound": float(bound),
                "margin": float(self.tier_margins[k]),
                "rows": rows,
                "served_invocation_rate":
                    float(disp_k[1:].sum()) / max(rows, 1.0),
                "routed_invocation_rate":
                    float(routed_k[1:].sum()) / max(rows, 1.0),
                "dropped_rows": dropped,
                "dropped_frac": dropped / max(rows, 1.0),
            })
        return per

    def derived_ladder(self, **kwargs):
        """``autotune.ladder_from_counts`` over this server's per-tick
        routed counts: capacity rungs whose per-class budgets track the
        observed class-count quantiles, the asymmetric ladder to deploy
        for the next run of this mix."""
        assert self.routed_history, \
            "no served invoke stats yet (needs use_mcma_dispatch ticks)"
        return at.ladder_from_counts(
            np.asarray(self.routed_history), self.batch,
            tier_margins=tuple(float(m) for m in self.tier_margins)
            if self.tier_bounds is not None else (), **kwargs)

    def _kv_bytes_resident(self) -> int:
        """Peak resident KV-cache bytes: a dense cache reserves batch x
        max_len for k and v whatever is held; a paged run pays for the
        pages of its high-water mark (the trash page is not counted); a
        pure-SSM cache holds no KV.  On a mesh, the whole deployment's:
        this rank's shard times the ranks it is split over."""
        k = self.cache.get("k")
        if k is None:
            return 0
        # a shard holds its kv heads (or its head_dim slice of each), and
        # on a dense cache 1 / |data| of it: its rows, or where the batch
        # does not divide, its slice of the sequence
        g = 1 if self.mesh is None else self.mesh.size(R.dp_axes(self.mesh))
        split = self.cfg.n_kv_heads * self.cfg.hd \
            // (k.shape[3] * k.shape[4]) * (1 if self.page_size else g)
        if not self.page_size:
            return 2 * k.numel() * k.element_size() * split
        per_page = 2 * k[:, 0].numel() * k.element_size() * split
        return per_page * self.page_hwm
