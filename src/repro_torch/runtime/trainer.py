"""Trainer (counterpart of ``repro/runtime/trainer.py``): the loop a
training job runs, on one device or as one rank of a ("data", "model")
mesh.

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
ends the step's wall time.

With ``mesh`` (a ``launch/mesh.HostMesh``; every rank builds the same
Trainer) the config must train there (``model.check_mesh_trainable``),
the state is this rank's shards under ``sharding/rules.state_pspecs``,
each step runs under ``steps.train_mesh_context`` on the rank's rows of
the global batch (``data/pipeline.local_batch``; a microbatch below the
data axes: every row and the rank's slice of the positions), and
checkpoints are
saved whole and restored onto any mesh.  ``history``, the straggler
flags and what ``run()`` returns are the same on every rank (a step's
wall time is the slowest rank's); rank 0 prints.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM, local_batch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.runtime import steps as steps_lib
from repro_torch.sharding import collectives as C


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
        self.cfg, self.tc, self.ds, self.mesh = cfg, tc, ds, mesh
        self.device = resolve_device(device)
        if mesh is not None:
            if ds.n_hosts != 1 or ds.global_batch % tc.grad_accum:
                raise ValueError(
                    f"a mesh trains on one host's global batch of "
                    f"{ds.global_batch} rows in {tc.grad_accum} equal "
                    f"microbatches (n_hosts={ds.n_hosts})")
            M.check_mesh_trainable(cfg, mesh,
                                   ds.global_batch // tc.grad_accum,
                                   ds.seq_len)
        self.monitor = StragglerMonitor()
        self.history: list[dict] = []
        self.step_fn = steps_lib.make_train_step(
            cfg, grad_accum=tc.grad_accum, base_lr=tc.base_lr,
            warmup=tc.warmup, total_steps=tc.total_steps)
        self.start_step = 0
        restored = None
        # ---- auto-restore ---------------------------------------------------
        if tc.ckpt_dir:
            restored, at = ckpt_lib.restore_train_state(
                tc.ckpt_dir, cfg, mesh=mesh, device=self.device)
        if restored is not None:
            self.state = restored
            self.start_step = int(at)
        else:
            self.state = steps_lib.init_train_state(
                seed, cfg, device=self.device, mesh=mesh)
        self.rank0 = mesh is None or mesh.rank == 0

    def _batch_at(self, step: int) -> dict:
        """The step's batch on the device: on a mesh this rank's rows."""
        batch = self.ds.batch_at(step)
        if self.mesh is not None:
            batch = local_batch(batch, self.mesh, self.tc.grad_accum)
        return {k: v.to(self.device) for k, v in batch.items()}

    def run(self) -> dict:
        t_start = time.time()
        step = self.start_step
        while step < self.tc.total_steps:
            if self.tc.fail_at is not None and step == self.tc.fail_at:
                raise PreemptionError(f"injected preemption at step {step}")
            batch = self._batch_at(step)
            t0 = time.time()
            with steps_lib.train_mesh_context(
                    self.mesh, self.ds.global_batch // self.tc.grad_accum):
                self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])           # blocks; honest step time
            dt = self._slowest(time.time() - t0)
            slow = self.monitor.observe(dt)
            step += 1
            rec = {"step": step, "loss": loss, "dt": dt, "slow": slow,
                   "grad_norm": float(metrics["grad_norm"])}
            self.history.append(rec)
            if self.rank0 and (step % self.tc.log_every == 0
                               or step == self.tc.total_steps):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({dt:.2f}s{' SLOW' if slow else ''})", flush=True)
            if self.tc.ckpt_dir and (step % self.tc.ckpt_every == 0
                                     or step == self.tc.total_steps):
                ckpt_lib.save_train_state(self.tc.ckpt_dir, step, self.cfg,
                                          self.state, mesh=self.mesh,
                                          keep_k=self.tc.keep_k)
        return {"steps": step - self.start_step,
                "final_loss": self.history[-1]["loss"] if self.history
                else None,
                "wall_s": self._slowest(time.time() - t_start),
                "slow_steps": self.monitor.slow_steps}

    def _slowest(self, seconds: float) -> float:
        """A host time as the slowest rank's on a mesh (the same on every
        rank), else as it is."""
        return seconds if self.mesh is None else C.world_max(seconds)
