"""Fault-tolerant training loop (counterpart of
``repro/train/trainer.py``):
  * checkpoint/restart: periodic async checkpoints (``checkpoint/``); on
    (re)start the loop resumes from the latest step, and the data
    pipeline is stateless in the step, so a resumed run repeats the
    uninterrupted one bit for bit;
  * failure injection: ``fail_at_step`` raises after that step ran and
    its checkpoint was written, before the next;
  * stragglers: each step's wall time feeds an EWMA; steps slower than
    ``straggler_factor`` times it are flagged and counted in the
    metrics;
  * a checkpoint the reference wrote (its stacked layout) resumes here
    too, carried across by ``core.convert``.

``kernel_fns`` defaults to ``ops.model_kernel_fns()``: on the card the
hand-written flash and wkv kernels run forward and backward, on the CPU
the same dispatch takes the plain versions. The reference's default is
None because its Pallas kernels cannot be differentiated.

With ``dist`` (a ``models.moe.DistContext`` on a mesh) every rank runs
the loop on its blocks of the state (``train.steps``): ``init_state``
cuts each rank's blocks from the same seeded parameters, a checkpoint
gathers them whole and rank 0 writes the one-device files, and
``restore_or_init`` keeps each rank's block of the stored tree -- on
whatever mesh this run has (the elastic restart). The device defaults
to ``cuda:<LOCAL_RANK>`` there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as tdist

from repro_torch.checkpoint import checkpointer as ck
from repro_torch.core import convert
from repro_torch.core.tree import leaves, tree_map
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch.mesh import rank_device
from repro_torch.models import model as model_lib
from repro_torch.models.moe import as_dist
from repro_torch.train.steps import (init_opt_state, make_train_step,
                                     opt_state_specs)


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class TrainerConfig:
    ckpt_dir: str
    total_steps: int = 100
    ckpt_every: int = 20         # <= 0: no checkpoints (a card benchmark)
    keep: int = 3
    log_every: int = 10
    peak_lr: float = 3e-4
    fail_at_step: int | None = None
    straggler_factor: float = 3.0
    seed: int = 0


@dataclass
class Trainer:
    cfg: object                  # ModelConfig
    tcfg: TrainerConfig
    data: DataConfig
    dist: object | None = None
    kernel_fns: dict | None = field(default_factory=ops.model_kernel_fns)
    device: object | None = None     # where the state goes (None: CUDA)
    metrics_log: list = field(default_factory=list)

    def __post_init__(self):
        self.dist = as_dist(self.dist, "Trainer")
        self._step_fn = make_train_step(self.cfg, self.dist,
                                        self.kernel_fns,
                                        peak_lr=self.tcfg.peak_lr)
        self._ckpt = ck.AsyncCheckpointer(self.tcfg.ckpt_dir,
                                          keep=self.tcfg.keep)

    # -- state ------------------------------------------------------------
    def init_state(self):
        """Random parameters (seed ``tcfg.seed``) and a fresh optimizer
        state on ``self.device`` (CUDA unless given); on a mesh the
        rank's blocks."""
        dev = resolve_device(self.device) if self.dist is None else \
            rank_device(self.device)
        params = model_lib.init_params(self.cfg, self.tcfg.seed, device=dev,
                                       dist=self.dist)
        return {"params": params,
                "opt": init_opt_state(self.cfg, params, self.dist)}

    def param_specs(self):
        return shd.param_specs(self.cfg, self.dist)[0]

    def shardings(self):
        """(spec tree of the state, dist) on a mesh, else None."""
        if self.dist is None:
            return None
        return ({"params": self.param_specs(),
                 "opt": opt_state_specs(self.cfg, self.dist)},
                self.dist)

    def restore_or_init(self):
        """(state, start step): the latest checkpoint under
        ``tcfg.ckpt_dir`` (the port's, or the reference's carried
        across), else ``init_state`` at step 0."""
        start = ck.latest_step(self.tcfg.ckpt_dir)
        state = self.init_state()
        if start is None:
            return state, 0
        if ck.manifest(self.tcfg.ckpt_dir, start).get("layout") == \
                ck.LAYOUT:
            return ck.restore(self.tcfg.ckpt_dir, state, start,
                              shardings=self.shardings())
        ref, start = ck.restore(self.tcfg.ckpt_dir, None, start)
        dev = leaves(state["params"])[0].device
        # on a mesh the whole state stays on the host, its blocks go over
        host = dev if self.dist is None else torch.device("cpu")
        params = convert.params_from_numpy(ref["params"], host)
        opt = convert.opt_state_from_numpy(ref["opt"], params, host)
        whole = {"params": params, "opt": opt}
        if self.dist is not None:
            whole = tree_map(lambda t: t.to(dev), shd.shard_tree(
                whole, self.shardings()[0], self.dist))
        return whole, start

    # -- loop -------------------------------------------------------------
    def run(self, state=None, start_step: int | None = None):
        if state is None:
            state, start_step = self.restore_or_init()
        start_step = start_step or 0
        dev = leaves(state["params"])[0].device
        ewma = None
        stragglers = 0
        for step in range(start_step, self.tcfg.total_steps):
            batch = batch_at(self.data, step, device=dev)
            t0 = time.perf_counter()
            params, opt, metrics = self._step_fn(
                state["params"], state["opt"], batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            state = {"params": params, "opt": opt}

            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            slow = dt > self.tcfg.straggler_factor * ewma
            stragglers += int(slow)
            metrics.update(step=step, step_time_s=dt, straggler=slow,
                           stragglers_total=stragglers)
            self.metrics_log.append(metrics)

            done = step + 1
            if self.tcfg.ckpt_every > 0 and (
                    done % self.tcfg.ckpt_every == 0
                    or done == self.tcfg.total_steps):
                self._ckpt.save_async(state, done, self.shardings())
            if self.tcfg.fail_at_step is not None and \
                    done == self.tcfg.fail_at_step:
                self._wait()
                raise SimulatedFailure(f"injected failure at step {done}")
        self._wait()
        return state

    def _wait(self):
        """The checkpoint written (on a mesh: by rank 0, for every
        rank)."""
        self._ckpt.wait()
        if self.dist is not None:
            tdist.barrier()

    def losses(self):
        return [m["loss"] for m in self.metrics_log]
