"""Fault-tolerant training loop with energy accounting (a port of
:mod:`repro.train.loop`).

  * checkpoint/restart: checkpoints every ``ckpt_every`` steps through
    :class:`repro_torch.ckpt.checkpoint.CheckpointManager` (host copies
    taken at the step, files written on a background thread); on
    (re)start the loop resumes from the latest complete checkpoint with
    the parameters, optimizer state, loader step and energy ledger as
    they were, so a restarted run continues as the uninterrupted one;
  * stragglers: each step's wall time is held against the rolling
    median; a step slower than ``straggler_factor`` × the median is
    counted and logged;
  * energy telemetry: each step's activity extends a simulated power
    timeline (:class:`~repro_torch.core.activity.ChipPowerModel`, 65-250
    W by default: a model, not the card's draw), an
    :class:`~repro_torch.core.sensor.OnboardSensor` polls it part-time,
    and an :class:`~repro_torch.core.ledger.EnergyLedger` records the
    naive sensor integral and the corrected energy with its uncertainty.

Step times are host wall clock around a step that ends in a
synchronisation of the device, so on the card they are the card's step
times.  Logging goes through :mod:`logging` (logger
``repro_torch.train``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.common.config import Config
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core import profiles
from repro_torch.core.activity import ChipPowerModel, StepActivity, steps_timeline
from repro_torch.core.calibrate import CalibrationRecord
from repro_torch.core.ledger import EnergyLedger
from repro_torch.core.sensor import OnboardSensor
from repro_torch.data.pipeline import LoaderState, SyntheticTokens
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step

log = logging.getLogger("repro_torch.train")

#: the sensor's poll period (s), as the reference's loop polls it
POLL_S = 0.005


@dataclasses.dataclass(frozen=True)
class LoopConfig(Config):
    total_steps: int = 50
    ckpt_every: int = 20
    log_every: int = 10
    straggler_factor: float = 2.0
    sensor_profile: str = "tpu_v5e_chip"
    sensor_seed: int = 0
    power_idle_w: float = 65.0
    power_peak_w: float = 250.0


@dataclasses.dataclass
class StragglerStats:
    times: list = dataclasses.field(default_factory=list)
    n_stragglers: int = 0

    def record(self, dt: float, factor: float) -> bool:
        med = float(np.median(self.times)) if self.times else dt
        self.times.append(dt)
        if len(self.times) > 200:
            self.times.pop(0)
        is_straggler = len(self.times) > 5 and dt > factor * med
        if is_straggler:
            self.n_stragglers += 1
        return is_straggler


class EnergyMonitor:
    """Per-run sensor simulation + naive/corrected ledger entries; the
    sensor on ``device``."""

    def __init__(self, lcfg: LoopConfig, device_id: str = "dev0",
                 device: DeviceLike = "cuda"):
        self.profile = profiles.get(lcfg.sensor_profile)
        self.sensor = OnboardSensor(self.profile, seed=lcfg.sensor_seed,
                                    device=device)
        self.model = ChipPowerModel(idle_w=lcfg.power_idle_w,
                                    peak_w=lcfg.power_peak_w)
        self.ledger = EnergyLedger(device_id=device_id)
        self.calib = CalibrationRecord(
            device_id=device_id, profile_name=self.profile.name,
            update_period_s=self.profile.update_period_s,
            window_s=self.profile.window_s,
            transient_kind="instant",
            rise_time_s=2.5 * self.profile.update_period_s,
            sampled_fraction=self.profile.sampled_fraction)
        self.t = 0.0

    def record_step(self, step: int, wall_s: float, util: float) -> None:
        act = StepActivity(compute_s=wall_s * util,
                           memory_s=min(wall_s, wall_s * 0.6),
                           collective_s=min(wall_s, wall_s * 0.3))
        # one-step timeline at the current simulated clock
        tl = steps_timeline(act, 1, self.model, t0=self.t)
        self.sensor.attach(tl, t_end=self.t + wall_s + 1.0, t_start=self.t)
        _, vals = self.sensor.poll(self.t, self.t + wall_s, period_s=POLL_S)
        naive = float(vals.sum()) * POLL_S
        # corrected: time-shift + window-coverage correction
        W = self.profile.window_s or self.profile.update_period_s
        ts2, vals2 = self.sensor.poll(self.t, self.t + wall_s + W, POLL_S)
        corrected = float(vals2[ts2 - W >= self.t].sum()) * POLL_S
        self.ledger.append(step, self.t, self.t + wall_s, naive, corrected,
                           0.05 * corrected)
        self.t += wall_s

    def state(self) -> str:
        return self.ledger.to_json()

    def load_state(self, s: str) -> None:
        self.ledger = EnergyLedger.from_json(s)
        if self.ledger.entries:
            self.t = self.ledger.entries[-1].t1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(cfg: ArchConfig, shape: ShapeCell, tcfg: TrainConfig,
                 lcfg: LoopConfig, ckpt_dir: Optional[str] = None,
                 seed: int = 0, device: DeviceLike = "cuda"
                 ) -> Dict[str, Any]:
    """Single-process training on ``device`` (the card by default):
    parameters drawn from ``seed``, :class:`SyntheticTokens` batches,
    :func:`make_train_step` steps, checkpoints in ``ckpt_dir`` (resumed
    from the latest one there).  Returns ``losses``, ``final_loss``,
    ``stragglers``, ``energy`` (the ledger's summary) and ``params`` as
    the reference does, and each run step's ``grad_norms`` and ``step_s``
    (wall seconds)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager, snapshot

    dev = resolve_device(device)
    params = api.init_params(seed, cfg, dev)
    opt_state = adamw.init(params)
    loader = SyntheticTokens(cfg, shape, seed=seed)
    monitor = EnergyMonitor(lcfg, device=dev)
    stats = StragglerStats()
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        s = mgr.latest_step()
        restored, extras = mgr.restore(s, {"params": params,
                                           "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        loader.state = LoaderState.from_dict(extras["loader"])
        monitor.load_state(extras["ledger"])
        start_step = s
        log.info("resumed at step %d", s)

    step_fn = make_train_step(cfg, tcfg)
    history, grad_norms, step_s = [], [], []
    it = iter(loader)
    # loader.state.step already points at the next batch (a pure
    # function of the step), so a resumed run skips nothing by hand
    for step in range(start_step, lcfg.total_steps):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(it).items()}
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])     # waits for the step
        _sync(dev)
        dt = time.perf_counter() - t0
        straggler = stats.record(dt, lcfg.straggler_factor)
        monitor.record_step(step, dt, util=0.5)
        if straggler:
            log.warning("straggler step %d: %.3fs", step, dt)
        if step % lcfg.log_every == 0:
            log.info("step %d loss=%.4f dt=%.1fms", step, loss, dt * 1e3)
        history.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        step_s.append(dt)
        if mgr is not None and (step + 1) % lcfg.ckpt_every == 0:
            mgr.save_async(step + 1, {"params": snapshot(params),
                                      "opt": snapshot(opt_state)},
                           extras={"loader": loader.state.to_dict(),
                                   "ledger": monitor.state()})
    if mgr is not None:
        mgr.wait()
    return {
        "losses": history,
        "final_loss": history[-1] if history else float("nan"),
        "stragglers": stats.n_stragglers,
        "energy": monitor.ledger.summary(),
        "params": params,
        "grad_norms": grad_norms,
        "step_s": step_s,
    }
