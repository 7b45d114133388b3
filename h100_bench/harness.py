"""One run of one cell: the port's ``DecodeServer`` driven in an open loop.

  1. weights drawn from the seed on the device (``weights.draw``) and
     loaded into the port's ``Model`` by name;
  2. the ``DecodeServer`` built with the mix's serving options;
  3. the cell's own shapes warmed: full chunk ticks and decode ticks;
  4. the mix's traffic from ``-preroll_s`` (set-up, so the slot table is
     as full as it stays), then the measured window of ``seconds``: each
     request is submitted before the first tick that starts at or after
     its due time;
  5. after the window the metrics are read (``metrics/<name>.py``), the
     program's state is freed, and the reference judges a sample of the
     finished requests (``judge``): each tick's rung and resident set by
     the frozen policy replayed over the stats the server handed its
     controllers (``Observed``, ``policy.replay``), those stats against
     its own routing, and the served tokens' logits
     (``check.served_gap``).

The harness stamps every time itself on the host clock: due times from
the schedule, a request's admission at the start of the tick that took
it into a slot, each output token at the end of the tick that produced
it (each tick ends in the server's device read).  With ``trace`` the last
``TRACE_S`` seconds of the window run under ``torch.profiler`` with one
annotation a tick, kept in memory; the host-clock per-layer metrics are
then read over the window before that stretch.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from h100_bench import check, policy, traffic
from h100_bench import weights as W

BENCH = Path(__file__).resolve().parent
TRACE_S = 8.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(name: str, root: Path = BENCH.parent) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration and mix
    (read from their files) and the metrics that apply to it."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    applies = lambda m: "workloads" not in m or name in m["workloads"]
    return dict(
        name=name, chips=cell["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ApproxConfig, ModelConfig, SSMConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields
          and k not in ("approx", "ssm")}
    kw["approx"] = ApproxConfig(**cfg["approx"])
    if "ssm" in cfg:
        kw["ssm"] = SSMConfig(**cfg["ssm"])
    return ModelConfig(**kw)


def cell_config(cell: dict) -> dict:
    """The cell's configuration as it is served: a mix that serves an
    approximator library sets the library's size."""
    cfg = json.loads(json.dumps(cell["config"]))
    lib = cell["traffic"]["serve"].get("library")
    if lib:
        cfg["approx"]["library_size"] = lib["library_size"]
    return cfg


def serve_options(cfg: dict, mix: dict):
    """The port's ``ServeOptions`` of a mix: MCMA dispatch at the
    configuration's scope and backend, greedy, no EOS, and the mix's
    ``serve`` section (a ``library`` there as a ``LibrarySpec``)."""
    from repro_torch.runtime.options import LibrarySpec, ServeOptions
    serve = dict(mix["serve"])
    if serve.get("library"):
        serve["library"] = LibrarySpec(**serve["library"])
    return ServeOptions(use_mcma_dispatch=True,
                        route_scope=cfg["approx"]["route_scope"],
                        backend=cfg["approx"]["backend"], greedy=True,
                        eos=None, seed=0, **serve)


def margins_of(cfg: dict, mix: dict):
    """The reference's QoS margins for a mix served with tiers (the
    default table around the configuration's error bound), else None."""
    if not mix["serve"].get("qos_tiers"):
        return None
    return check.tier_margins(cfg["approx"].get("error_bound", 0.1),
                              scale=mix["serve"].get("qos_margin_scale", 4.0))


def load_weights(model, drawn: dict):
    """Each drawn tensor into the parameter of its name; a serving-layout
    stack (padded, with the zero pseudo-class last) takes it in its
    leading block and is zero elsewhere."""
    named = dict(model.named_parameters())
    for name, t in drawn.items():
        p = named.pop(name)
        if p.shape == t.shape:
            p.data.copy_(t)
        else:
            p.data.zero_()
            p.data[tuple(slice(0, s) for s in t.shape)].copy_(t)
    if named:
        raise ValueError(f"parameters the benchmark does not draw: "
                         f"{sorted(named)}")


@dataclasses.dataclass
class Req:
    due: float
    req: object
    admit: float | None = None
    tokens: list = dataclasses.field(default_factory=list)


class Observed:
    """The stats each decode tick hands the server's controllers (routed
    class counts, dropped rows, routed counts over the library), from the
    server's construction on, so that the frozen policy can be replayed
    over them (``policy.replay``)."""

    def __init__(self, srv):
        self.stats: list[dict] = []
        observe = srv._observe_decode

        def observed(host):
            observe(host)
            lib = host.get("lib_counts")
            self.stats.append(dict(
                class_counts=np.array(host["class_counts"], np.int64),
                dropped=float(host["dropped_rows"]),
                lib_counts=None if lib is None else np.array(lib, np.int64)))
        srv._observe_decode = observed


class Recorder:
    """What each tick did, read from the server's slot table after it:
    which positions of which requests it processed (``ticks``, the
    schedule the reference needs), the tokens it produced (stamped at its
    end), admissions (stamped at its start), and on decode ticks the rows
    it dispatched to each class."""

    def __init__(self, srv, observed: Observed | None = None):
        self.srv = srv
        self.observed = observed
        self.reqs: dict[int, Req] = {}
        self.active: dict[int, tuple] = {}      # rid -> (slot, written, n_out)
        self.ticks: list[check.Tick] = []
        self.times: list[tuple] = []            # (t0, t1, phase)
        self.queued: list[int] = []             # queue length after a tick
        self.disp: list = []                    # per tick, decode only
        self._disp = self._copy(srv.dispatched_sum)
        self._pre = (None, None, 0)

    def before_tick(self):
        """The tick's resident set and capacity rung, as the server holds
        them when it starts the tick (its controllers move them after),
        and how many decode ticks they had observed."""
        srv = self.srv
        res = None if srv.residency is None \
            else tuple(int(c) for c in srv.residency)
        point = None
        if srv.controller is not None:
            p = srv.controller.ladder[srv.controller.index]
            point = (p.exact_frac, tuple(p.class_fracs(srv.cfg.approx.n_approx)),
                     p.shard_slack)
        obs = 0 if self.observed is None else len(self.observed.stats)
        self._pre = (res, point, obs)

    @staticmethod
    def _copy(a):
        return None if a is None else np.array(a, np.float64)

    def after_tick(self, t0: float, t1: float, busy: bool = True):
        """Record the tick that ran from ``t0`` to ``t1``; one that found
        no slot busy (``busy`` false) processed nothing."""
        srv = self.srv
        phase = srv.tick_log[-1][0] if busy else "idle"
        seen, rows = {}, []
        for i, r in enumerate(srv.slots):
            if r is not None:
                seen[r.rid] = (r, i, len(r.prompt)
                               - srv.remaining_prompt[i].size
                               + max(len(r.out) - 1, 0))
        for rid, (slot, _, _) in self.active.items():
            if rid not in seen:                 # finished in this tick
                r = self.reqs[rid].req
                seen[rid] = (r, slot, len(r.prompt) + len(r.out) - 1)
        active = {}
        for rid, (r, slot, w) in seen.items():
            rec = self.reqs[rid]
            w0, n0 = self.active.get(rid, (slot, 0, 0))[1:]
            if rec.admit is None:
                rec.admit = t0
            if w > w0:
                rows.append((rid, slot, w0, w - w0))
            rec.tokens.extend([t1] * (len(r.out) - n0))
            if not r.done:
                active[rid] = (slot, w, len(r.out))
        self.active = active
        self.ticks.append(check.Tick(
            srv.prefill_chunk if phase == "prefill" else 0,
            np.asarray(rows, np.int64).reshape(-1, 4), *self._pre))
        self.times.append((t0, t1, phase))
        self.queued.append(len(srv.queue))
        d = self._copy(srv.dispatched_sum)
        self.disp.append(None if phase != "decode" or d is None
                         else d - (0 if self._disp is None else self._disp))
        self._disp = d


def counters(srv) -> dict:
    """The server's own cumulative counts, copied."""
    c = lambda a: None if a is None else np.array(a, np.float64)
    return dict(dispatched=c(srv.dispatched_sum), routed=c(srv.routed_sum),
                dropped=float(srv.dropped_sum),
                prefill_inv=float(srv.prefill_invocation_sum),
                prefill_tokens=int(srv.prefill_tokens),
                off_set=float(srv.off_set_sum), lib=c(srv.lib_routed_sum))


def warm(srv, vocab: int, rng: np.random.Generator, Request):
    """The cell's shapes once each, twice over: every slot takes a prompt
    one token longer than a chunk (a full chunk tick, then decode ticks)
    or, without chunking, a two-token prompt; drained."""
    plen = srv.prefill_chunk + 2 if srv.prefill_chunk else 2
    for rep in range(2):
        for i in range(srv.batch):
            srv.submit(Request(rid=-1 - i - rep * srv.batch,
                               prompt=rng.integers(0, vocab, plen,
                                                   dtype=np.int32),
                               max_new=2))
        while srv.queue or any(s is not None for s in srv.slots):
            srv.tick()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(srv, plan, rec: Recorder, w0: float, w1: float, Request,
          profiler=None, clock=time.perf_counter):
    """The open loop until ``w1`` on ``clock``.  Returns (counters at the
    window's start, counters at its end, host time the profiler started
    or None, the profiler's context or None)."""
    i, c0, prof, t_prof = 0, None, None, None
    while True:
        now = clock()
        if now >= w1:
            break
        if c0 is None and now >= w0:
            c0 = counters(srv)
        if profiler is not None and prof is None and now >= w1 - TRACE_S:
            prof = profiler()
            prof.__enter__()
            t_prof = clock()
        while i < len(plan) and w0 + plan[i].due <= now:
            p = plan[i]
            r = Request(rid=p.idx, prompt=p.prompt, max_new=p.max_new,
                        tier=p.tier)
            rec.reqs[p.idx] = Req(w0 + p.due, r)
            srv.submit(r)
            i += 1
        rec.before_tick()
        t0 = clock()
        if prof is not None:
            with torch.profiler.record_function("bench.tick"):
                busy = srv.tick()
        else:
            busy = srv.tick()
        if busy or prof is not None:
            rec.after_tick(t0, clock(), busy)
        elif i < len(plan) and clock is time.perf_counter:
            time.sleep(max(0.0, min(w0 + plan[i].due - clock(), 0.002)))
    return c0 or counters(srv), counters(srv), t_prof, prof


def read_trace(prof, rec: Recorder, t_prof: float) -> dict | None:
    """The traced stretch: every device operation (kernels, copies,
    fills) with its name, start and length, and each traced tick's span,
    phase and dispatched rows, in the profiler's clock."""
    spans, names, starts, durs = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        on_device = str(e.device_type()).endswith("CUDA")
        if e.name() == "bench.tick":
            # the annotation's host span (kineto mirrors it on the device)
            if not on_device:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif on_device:
            names.append(e.name())
            starts.append(e.start_ns())
            durs.append(e.duration_ns())
    traced = [k for k, t in enumerate(rec.times) if t[0] >= t_prof]
    spans.sort()
    if not spans or len(spans) != len(traced):
        print(f"trace: {len(spans)} tick spans for {len(traced)} ticks",
              file=sys.stderr)
        return None
    return dict(names=names, start=np.asarray(starts, np.int64),
                dur=np.asarray(durs, np.int64),
                spans=np.asarray(spans, np.int64),
                phases=[rec.times[k][2] for k in traced],
                disp=[rec.disp[k] for k in traced])


def load_metric(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _pick_sample(rec: Recorder, w0: float, w1: float, seed: int,
                 target: int, most: int) -> list:
    """The requests to judge, drawn from the seed among those finished in
    the window (else in the run): the one with the most served tokens,
    then others until ``target`` tokens or ``most`` requests."""
    done = [k for k, r in rec.reqs.items()
            if r.req.done and not r.req.aborted and r.tokens]
    inside = [k for k in done if w0 <= rec.reqs[k].tokens[-1] < w1]
    pool = sorted(inside or done)
    if not pool:
        return []
    longest = max(pool, key=lambda k: (len(rec.reqs[k].req.out), -k))
    rest = [k for k in pool if k != longest]
    rest = [rest[j] for j in
            np.random.default_rng([seed % (1 << 63), 3]).permutation(
                len(rest))]
    out, n = [longest], len(rec.reqs[longest].req.out)
    for k in rest:
        if n >= target or len(out) >= most:
            break
        out.append(k)
        n += len(rec.reqs[k].req.out)
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault=None, control: bool = False,
             keep: dict | None = None, clock=time.perf_counter) -> dict:
    """One run; returns the result line's dict (``check`` last).
    ``control`` also reads the control's gap on the same sample.  Tests
    pass ``fault(srv)``, which breaks the timed path before the traffic,
    ``keep``, which receives the schedule and the requests, and a
    ``clock`` of their own, so that the loop's batching does not depend
    on the machine's speed."""
    from repro_torch.models import model as M
    from repro_torch.runtime.server import DecodeServer, Request

    cfg_d, mix = cell_config(cell), cell["traffic"]
    device = torch.device(device)
    cfg = port_config(cfg_d)
    drawn = W.draw(cfg_d, seed, device, cfg.pdtype)
    model = M.init_model(None, cfg, device=device)
    load_weights(model, drawn)
    del drawn
    srv = DecodeServer(cfg, model, options=serve_options(cfg_d, mix))
    observed = Observed(srv)
    warm(srv, cfg_d["vocab"], np.random.default_rng([seed % (1 << 63), 4]),
         Request)
    if fault is not None:
        fault(srv)
    plan = traffic.schedule(mix, cfg_d["vocab"], seed, seconds)
    rec = Recorder(srv, observed)
    _sync(device)
    w0 = clock() + float(mix["preroll_s"])
    w1 = w0 + seconds
    profiler = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = lambda: torch.profiler.profile(activities=acts)
        with profiler():                # loads the tracer in set-up
            torch.zeros(1, device=device).add_(1)
    c0, c1, t_prof, prof = drive(srv, plan, rec, w0, w1, Request, profiler,
                                 clock)
    _sync(device)
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        tr = read_trace(prof, rec, t_prof)
        del prof
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    kv = kv_held(srv, cfg_d) if srv.page_size else None
    run = dict(cfg=cfg_d, batch=srv.batch, w0=w0, w1=w1, seconds=seconds,
               setup_s=w0 - t_start, reqs=rec.reqs, times=rec.times,
               ticks=rec.ticks, disp=rec.disp, c0=c0, c1=c1, trace=tr,
               host_end=t_prof if t_prof is not None else w1)
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in entries:
        v = load_metric(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    due = [r for r in rec.reqs.values() if w0 <= r.due < w1]
    requests = {k: dict(prompt=np.asarray(r.req.prompt),
                        out=list(r.req.out), tier=r.req.tier)
                for k, r in rec.reqs.items()}
    ck = cfg_d["check"]
    sample = _pick_sample(rec, w0, w1, seed, ck["sample_tokens"],
                          ck["sample_requests"])
    ticks, batch, stats = rec.ticks, srv.batch, observed.stats
    if keep is not None:
        keep.update(ticks=ticks, requests=requests, sample=sample)
    line = dict(correct=False, attempted=len(due),
                failed=sum(1 for r in due if r.req.aborted),
                metrics=metrics,
                device=dict(platform="gpu" if device.type == "cuda"
                            else device.type,
                            kind=torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu",
                            count=1, memory_peak_bytes=int(peak)))
    if tr is not None:
        from h100_bench.metrics import _trace
        busy_s, window_s = _trace.busy(tr)
        line["device"].update(busy_s=busy_s, window_s=window_s)
        line["breakdown"] = _trace.breakdown(tr)
    if kv is not None:
        line["kv"] = kv
    # the program's state goes before the reference runs
    del srv, model, rec, run, tr, due, observed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res = judge(cfg_d, mix["serve"], seed, device, batch, ticks, stats,
                requests, sample, control, margins_of(cfg_d, mix))
    line["correct"] = res.pop("correct")
    line["check"] = res.pop("check")
    line["_extra"] = res
    return line


def kv_held(srv, cfg_d: dict) -> dict:
    """What the traffic held of a paged KV cache against what the server
    reserved: the page pool's high-water mark and size, and their
    bytes."""
    page = srv.page_size * 2 * cfg_d["n_layers"] * cfg_d["n_kv_heads"] \
        * (cfg_d["d_model"] // cfg_d["n_heads"]) \
        * torch.finfo(getattr(torch, cfg_d["act_dtype"])).bits // 8
    return dict(pages_hwm=int(srv.page_hwm), pages_pool=int(srv.n_pages),
                held_bytes=int(srv.page_hwm * page),
                pool_bytes=int(srv.n_pages * page))


def judge(cfg_d: dict, serve: dict, seed: int, device, batch: int,
          ticks: list, stats: list, requests: dict, sample: list,
          control: bool, margins=None) -> dict:
    """The reference's verdict on ``sample``: the weights drawn anew from
    the seed; each tick's capacity rung and resident set from the frozen
    policy replayed over the stats the server's controllers were handed
    (``stats``), with the ticks where the program's differ counted; on
    the decode ticks the reference routes whole, the program's routed
    counts and drops against the reference's; the widest normalized logit
    gap of the served tokens against the configuration's limit (and with
    ``control`` the control's gap)."""
    from h100_bench import reference as R
    R.float32_matmuls()
    states = policy.replay(cfg_d, serve, batch, stats)
    off_policy = sum(1 for tk in ticks
                     if (tk.residency, tk.point) != states[tk.obs])
    ticks = [dataclasses.replace(tk, residency=states[tk.obs][0],
                                 point=states[tk.obs][1]) for tk in ticks]
    drawn = W.draw(cfg_d, seed, device, getattr(torch, cfg_d["param_dtype"]))
    counts = {}
    with torch.no_grad():
        res = check.served_gap(cfg_d, check.float32_view(drawn), batch,
                               ticks, requests, sample, device,
                               check.fp8_view(drawn) if control else None,
                               {k: r["tier"] for k, r in requests.items()},
                               margins, counts)
    counts_off = check.counts_off(ticks, stats, counts)
    limit = float(cfg_d["check"]["gap_limit"])
    res["correct"] = bool(sample) and res["undecided"] == 0 \
        and off_policy == 0 and counts_off == 0 and res["gap"] <= limit
    res["check"] = {"off_policy": {"value": off_policy, "limit": 0},
                    "counts_off": {"value": counts_off, "limit": 0},
                    "undecided": {"value": res["undecided"], "limit": 0},
                    "unsampled": {"value": int(not sample), "limit": 0},
                    "logit_gap": {"value": res["gap"], "limit": limit}}
    res["sample"] = len(sample)
    res["counted_ticks"] = sum(1 for k in counts if ticks[k].chunk == 0)
    return res
