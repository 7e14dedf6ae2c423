"""Fleet-level energy telemetry with uncertainty propagation.

The counterpart of :mod:`repro.core.telemetry`: the paper's data-centre
argument.  Per-device ±5 % gain errors are i.i.d. within the shunt
tolerance, so the *relative* fleet uncertainty shrinks as 1/√N, but only
if the errors are independent; a procurement batch sharing a resistor lot
does not average out, so the ledger also reports the worst-case (fully
correlated) bound.

:class:`FleetLedger` takes batches of per-device energies as float64
tensors on any device (or numpy arrays): sums run where the data lives,
and :meth:`FleetLedger.summary` reads them to the host once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.calibrate import CalibrationRecord
from repro_torch.core.ledger import EnergyLedger

F64 = torch.float64

#: per-device relative energy uncertainty: the ±5 % shunt-resistor
#: tolerance (paper §6) uncalibrated, and a 1 % floor once calibrated
#: (post-correction error std ~0.25 %, plus drift headroom)
SHUNT_TOLERANCE = 0.05
CALIBRATED_TOLERANCE = 0.01


@dataclasses.dataclass
class FleetSummary:
    n_devices: int
    total_j: float
    sigma_independent_j: float
    sigma_worstcase_j: float
    mean_power_w: float
    kwh: float
    cost_usd: float
    cost_sigma_usd: float
    annual_cost_uncertainty_usd: float


def _f64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor, on its own device (numpy and Python
    values on the CPU) unless ``device`` is given."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return x.to(dtype=F64, device=device)


class FleetLedger:
    """Aggregates per-device ledgers and calibrations across a fleet.

    Two registration paths: :meth:`register` keeps one
    :class:`~repro_torch.core.ledger.EnergyLedger` per device (fine up to
    a few hundred devices), while :meth:`register_batch` takes a whole
    fleet's energies as one tensor from the batched audit or the monitor.
    :meth:`summary` folds both.
    """

    def __init__(self, price_usd_per_kwh: float = 0.35):
        self.price = price_usd_per_kwh
        self.ledgers: Dict[str, EnergyLedger] = {}
        self.calibrations: Dict[str, CalibrationRecord] = {}
        # (energies_j, sigmas_j, duration_s, labels)
        self._batches: List[tuple] = []

    def register(self, ledger: EnergyLedger,
                 calib: Optional[CalibrationRecord] = None) -> None:
        self.ledgers[ledger.device_id] = ledger
        if calib is not None:
            self.calibrations[calib.device_id] = calib

    def register_batch(self, energies_j, sigmas_j=None,
                       duration_s: float = 0.0, calibrated: bool = False,
                       labels=None) -> None:
        """Register a fleet's energies (a float64 tensor on any device, or
        numpy).  ``sigmas_j`` defaults to the object path's per-device
        model: 5 % shunt tolerance uncalibrated, 1 % calibrated.
        ``labels`` tags each device with its workload scenario (one
        string, or [N] on the host) for :meth:`by_label`."""
        e = _f64(energies_j)
        if sigmas_j is None:
            s = (CALIBRATED_TOLERANCE if calibrated else SHUNT_TOLERANCE) * e
        else:
            s = torch.broadcast_to(_f64(sigmas_j, e.device), e.shape).clone()
        if labels is None:
            lab = None
        else:
            lab = np.broadcast_to(np.asarray(labels, dtype=object),
                                  tuple(e.shape)).copy()
        self._batches.append((e, s, float(duration_s), lab))

    def register_monitor(self, monitor, t: Optional[float] = None,
                         corrected: bool = True) -> None:
        """Fold a live :class:`~repro_torch.core.stream.MonitorService`
        snapshot into the ledger, on the monitor's device.

        Per-device energies come from ``monitor.fleet_energy(t)`` (devices
        outside ring coverage contribute nothing); sigmas take the
        calibrated tolerance for gain-calibrated devices and the shunt
        tolerance otherwise; the duration is the reporting devices' span
        of first to last sample; the monitor's labels flow into
        :meth:`by_label`.
        """
        fe = monitor.fleet_energy(t, corrected=corrected)
        e = torch.where(fe.covered, torch.nan_to_num(fe.per_device_j), 0.0)
        tol = torch.where(monitor.corrections.calibrated,
                          e.new_tensor(CALIBRATED_TOLERANCE),
                          SHUNT_TOLERANCE)
        st = monitor.state
        any_has, last, first = torch.stack([
            st.has.any().to(F64),
            torch.where(st.has, st.last_t, -torch.inf).max(),
            torch.where(st.has, st.first_t, torch.inf).min()]).tolist()
        dur = float(last - first) if any_has else 0.0
        self.register_batch(e, sigmas_j=tol * e.abs(), duration_s=dur,
                            labels=monitor.labels)

    def _device_sigma(self, device_id: str, energy_j: float) -> float:
        calib = self.calibrations.get(device_id)
        if calib is not None and calib.gain is not None:
            return CALIBRATED_TOLERANCE * energy_j
        return SHUNT_TOLERANCE * energy_j

    def summary(self) -> FleetSummary:
        """Fold the object-path ledgers and the batches into one summary.

        ``mean_power_w`` treats registered groups as concurrent: each
        group (one per-device ledger, or one batch) converts its energy
        to power over its own duration, and the fleet draw is the sum.
        """
        if not self.ledgers and not self._batches:
            return FleetSummary(0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        totals = []
        sigmas = []
        mean_p = 0.0
        n_devices = len(self.ledgers)
        for dev, led in self.ledgers.items():
            e = led.total_corrected_j
            totals.append(e)
            sigmas.append(self._device_sigma(dev, e))
            if led.total_duration_s > 0:
                mean_p += e / led.total_duration_s
        total = float(np.sum(totals)) if totals else 0.0
        sig_sq = float(np.sum(np.square(sigmas))) if sigmas else 0.0
        sig_wc = float(np.sum(sigmas)) if sigmas else 0.0
        if self._batches:
            dev0 = self._batches[0][0].device
            sums = torch.stack([
                torch.stack([e.sum(), s.square().sum(), s.sum()]).to(dev0)
                for e, s, _, _ in self._batches]).tolist()
        else:
            sums = []
        for (e_sum, sq_sum, s_sum), (e, _, dur, _) in zip(sums,
                                                          self._batches):
            n_devices += len(e)
            total += e_sum
            sig_sq += sq_sum
            sig_wc += s_sum
            if dur > 0:
                mean_p += e_sum / dur
        sig_ind = float(np.sqrt(sig_sq))
        kwh = total / 3.6e6
        # annualised uncertainty if this fleet ran at this mean power all
        # year
        annual_kwh_sigma = ((sig_wc / max(total, 1e-9)) * mean_p * 8760.0
                            / 1000.0)
        return FleetSummary(
            n_devices=n_devices,
            total_j=total,
            sigma_independent_j=sig_ind,
            sigma_worstcase_j=sig_wc,
            mean_power_w=mean_p,
            kwh=kwh,
            cost_usd=kwh * self.price,
            cost_sigma_usd=(sig_wc / 3.6e6) * self.price,
            annual_cost_uncertainty_usd=annual_kwh_sigma * self.price,
        )

    def by_label(self) -> Dict[str, FleetSummary]:
        """Per-scenario fleet summaries over the batches: which job
        classes carry the energy, and the uncertainty, of the bill.
        Unlabelled batch devices fall under ``"(unlabelled)"``; the
        object-path ledgers carry no label and are left out."""
        groups: Dict[str, List[tuple]] = {}
        for e, s, dur, lab in self._batches:
            if lab is None:
                groups.setdefault("(unlabelled)", []).append((e, s, dur))
                continue
            for label in sorted(set(lab.tolist())):
                sel = torch.as_tensor(lab == label, device=e.device)
                groups.setdefault(str(label), []).append(
                    (e[sel], s[sel], dur))
        out: Dict[str, FleetSummary] = {}
        for label, parts in sorted(groups.items()):
            sub = FleetLedger(price_usd_per_kwh=self.price)
            for e, s, dur in parts:
                sub._batches.append((e, s, dur, None))
            out[label] = sub.summary()
        return out


def datacenter_projection(n_gpus: int = 10_000, tdp_w: float = 700.0,
                          gain_tol: float = 0.05, duty: float = 0.8,
                          price_usd_per_kwh: float = 0.35) -> dict:
    """The paper's headline: ±5 % of 700 W ≈ ±35 W per GPU; for a
    10k-GPU centre that is ~$1M/yr of unaccounted electricity."""
    err_w = gain_tol * tdp_w
    fleet_err_w = err_w * n_gpus * duty
    annual_kwh = fleet_err_w * 8760.0 / 1000.0
    return {
        "per_gpu_err_w": err_w,
        "fleet_err_mw": fleet_err_w / 1e6,
        "annual_err_kwh": annual_kwh,
        "annual_err_usd": annual_kwh * price_usd_per_kwh,
    }
