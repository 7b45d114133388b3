"""Trainer (counterpart of ``repro/runtime/trainer.py``): the loop a
training job runs on one device.

  * the train step of runtime/steps.py on the train state, in place;
  * deterministic data from ``data.pipeline.batch_at(step)``: a restart
    replays nothing;
  * a checkpoint every ``ckpt_every`` steps (atomic, keep-k, in the
    reference's layout) and AUTO-RESTORE of the newest one at start-up,
    so a preempted job resumes by being started again;
  * a fault injection hook (``fail_at``) that raises as a preemption
    would;
  * a straggler monitor: an EWMA of the step's wall time that flags
    outliers.

One host read per step (``float(metrics["loss"])``, then the grad norm)
ends the step's wall time.  A training mesh is not ported yet (ROADMAP queue 1,
item 14).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch import checkpoint as ckpt_lib
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.runtime import steps as steps_lib


class PreemptionError(RuntimeError):
    """Injected fault (simulated SIGTERM mid-run)."""


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 2.5
    ewma: float = 0.0
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        if self.ewma == 0.0:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        self.slow_steps += slow
        return slow


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = ""
    keep_k: int = 3
    base_lr: float = 3e-4
    warmup: int = 20
    grad_accum: int = 1
    log_every: int = 10
    fail_at: int | None = None        # fault injection (tests)


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig, ds: SyntheticLM,
                 mesh=None, seed: int = 0, device=None):
        if mesh is not None:
            raise NotImplementedError("a training mesh is not ported yet "
                                      "(ROADMAP queue 1, item 14)")
        self.cfg, self.tc, self.ds, self.mesh = cfg, tc, ds, mesh
        self.device = resolve_device(device)
        self.monitor = StragglerMonitor()
        self.history: list[dict] = []
        self.step_fn = steps_lib.make_train_step(
            cfg, grad_accum=tc.grad_accum, base_lr=tc.base_lr,
            warmup=tc.warmup, total_steps=tc.total_steps)
        self.start_step = 0
        restored = None
        # ---- auto-restore ---------------------------------------------------
        if tc.ckpt_dir:
            restored, at = ckpt_lib.restore(tc.ckpt_dir)
        if restored is not None:
            self.state = convert.train_state_from_jax(cfg, restored,
                                                      device=self.device)
            self.start_step = int(at)
        else:
            self.state = steps_lib.init_train_state(seed, cfg,
                                                    device=self.device)

    def run(self) -> dict:
        t_start = time.time()
        step = self.start_step
        while step < self.tc.total_steps:
            if self.tc.fail_at is not None and step == self.tc.fail_at:
                raise PreemptionError(f"injected preemption at step {step}")
            batch = {k: v.to(self.device)
                     for k, v in self.ds.batch_at(step).items()}
            t0 = time.time()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])           # blocks; honest step time
            dt = time.time() - t0
            slow = self.monitor.observe(dt)
            step += 1
            rec = {"step": step, "loss": loss, "dt": dt, "slow": slow,
                   "grad_norm": float(metrics["grad_norm"])}
            self.history.append(rec)
            if step % self.tc.log_every == 0 or step == self.tc.total_steps:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({dt:.2f}s{' SLOW' if slow else ''})", flush=True)
            if self.tc.ckpt_dir and (step % self.tc.ckpt_every == 0
                                     or step == self.tc.total_steps):
                ckpt_lib.save(self.tc.ckpt_dir, step,
                              convert.train_state_to_tree(self.cfg,
                                                          self.state),
                              keep_k=self.tc.keep_k)
        return {"steps": step - self.start_step,
                "final_loss": self.history[-1]["loss"] if self.history
                else None,
                "wall_s": time.time() - t_start,
                "slow_steps": self.monitor.slow_steps}
