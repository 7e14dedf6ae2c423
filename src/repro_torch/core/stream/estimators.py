"""Online estimators and correction parameters for the streaming monitor.

The counterparts of :mod:`repro.core.stream.estimators`:

* :class:`OnlinePeriodEstimator` — per-device log-spaced histograms of
  complete run durations on the card; the estimate is the mean duration
  inside the median bin.
* :class:`StreamCorrections` — the paper's §5 per-device correction
  parameters as stacked [N] tensors.
* :func:`default_calibrations` — nominal records from the catalog.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import profiles as _profiles
from repro_torch.core.calibrate import CalibrationRecord, nominal_record

F64, I64 = torch.float64, torch.int64


class OnlinePeriodEstimator:
    """Per-device streaming update-period estimate from complete runs."""

    def __init__(self, n_devices: int, lo_s: float = 1e-3,
                 hi_s: float = 100.0, n_bins: int = 24,
                 min_runs: int = 3, *, device: DeviceLike = "cuda"):
        if not (0.0 < lo_s < hi_s):
            raise ValueError(f"bad histogram range [{lo_s}, {hi_s}]")
        if n_bins < 2:
            raise ValueError("need at least two histogram bins")
        dev = resolve_device(device)
        self.min_runs = int(min_runs)
        # interior edges (the reference's np.geomspace values): bin 0
        # catches everything below lo_s, the last bin everything above hi_s
        self.edges = torch.as_tensor(np.geomspace(lo_s, hi_s, n_bins - 1),
                                     dtype=F64, device=dev)
        self.counts = torch.zeros((n_devices, n_bins), dtype=I64, device=dev)
        self.sums = torch.zeros((n_devices, n_bins), dtype=F64, device=dev)

    def nbytes(self) -> int:
        return self.edges.nbytes + self.counts.nbytes + self.sums.nbytes

    def record(self, dev: torch.Tensor, durations: torch.Tensor) -> None:
        """Fold one slab's completed runs (device ids + durations).
        Counts are exact; sums on the card add in no fixed order."""
        if dev.numel() == 0:
            return
        b = torch.searchsorted(self.edges, durations, right=True)
        self.counts.index_put_((dev, b), torch.ones_like(dev),
                               accumulate=True)
        self.sums.index_put_((dev, b), durations, accumulate=True)

    @property
    def n_runs(self) -> torch.Tensor:
        return self.counts.sum(dim=1)

    def estimates(self) -> torch.Tensor:
        """[N] update-period estimates; nan below ``min_runs`` complete
        runs."""
        n = self.n_runs
        cum = torch.cumsum(self.counts, dim=1)
        need = (n + 1) // 2
        bstar = (cum >= need[:, None]).to(torch.int8).argmax(dim=1)
        cnt = torch.gather(self.counts, 1, bstar[:, None])[:, 0]
        est = (torch.gather(self.sums, 1, bstar[:, None])[:, 0]
               / torch.clamp_min(cnt, 1))
        return torch.where((n >= self.min_runs) & (cnt > 0), est,
                           float("nan"))


@dataclasses.dataclass(frozen=True)
class StreamCorrections:
    """Per-device §5 correction parameters as stacked [N] tensors:
    ``corrected = (reading - offset_w) / gain``; ``time_shift_s`` moves
    reported timestamps back by the averaging window; ``baseline_w`` is
    debited from every raw reading; ``ref_period_s`` is the calibration's
    update period; ``calibrated`` marks gain-calibrated devices."""

    gain: torch.Tensor
    offset_w: torch.Tensor
    time_shift_s: torch.Tensor
    baseline_w: torch.Tensor
    ref_period_s: torch.Tensor
    calibrated: torch.Tensor

    def __post_init__(self):
        n = self.gain.shape[0]
        for fld in dataclasses.fields(self):
            a = getattr(self, fld.name)
            if tuple(a.shape) != (n,):
                raise ValueError(f"{fld.name} must be [{n}], "
                                 f"got {tuple(a.shape)}")
        if bool((self.gain == 0.0).any()):
            raise ValueError("correction gain must be non-zero")

    @property
    def n_devices(self) -> int:
        return self.gain.shape[0]

    def to(self, device: DeviceLike) -> "StreamCorrections":
        dev = resolve_device(device)
        return StreamCorrections(**{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)})

    @classmethod
    def identity(cls, n: int, baseline_w=0.0, ref_period_s: float = 0.1, *,
                 device: DeviceLike = "cuda") -> "StreamCorrections":
        """No-op corrections: corrected energy equals raw energy."""
        dev = resolve_device(device)
        return cls(gain=torch.ones(n, dtype=F64, device=dev),
                   offset_w=torch.zeros(n, dtype=F64, device=dev),
                   time_shift_s=torch.zeros(n, dtype=F64, device=dev),
                   baseline_w=torch.as_tensor(baseline_w, dtype=F64,
                                              device=dev).expand(n).clone(),
                   ref_period_s=torch.full((n,), float(ref_period_s),
                                           dtype=F64, device=dev),
                   calibrated=torch.zeros(n, dtype=torch.bool, device=dev))

    @classmethod
    def from_calibrations(cls, profile_names: Sequence[str],
                          calibs: Dict[str, CalibrationRecord],
                          baseline_w=0.0, apply_gain: bool = True,
                          time_shift: bool = True, *,
                          device: DeviceLike = "cuda") -> "StreamCorrections":
        """Gather per-device parameters from calibration records keyed by
        profile name."""
        dev = resolve_device(device)
        names = list(profile_names)
        n = len(names)
        uniq = sorted(set(names))
        missing = [u for u in uniq if u not in calibs]
        if missing:
            raise KeyError("no calibration record for profile(s): "
                           + ", ".join(missing))
        rows = {u: i for i, u in enumerate(uniq)}
        code = torch.tensor([rows[x] for x in names], dtype=I64)

        def field(fn, dtype=F64):
            table = torch.tensor([fn(calibs[u]) for u in uniq], dtype=dtype)
            return table[code].to(dev)

        ones = torch.ones(n, dtype=F64, device=dev)
        zeros = torch.zeros(n, dtype=F64, device=dev)
        return cls(
            gain=field(lambda c: c.correction_gain) if apply_gain else ones,
            offset_w=(field(lambda c: c.correction_offset_w) if apply_gain
                      else zeros),
            time_shift_s=(field(lambda c: c.time_shift_s) if time_shift
                          else zeros.clone()),
            baseline_w=torch.as_tensor(baseline_w, dtype=F64,
                                       device=dev).expand(n).clone(),
            ref_period_s=field(lambda c: c.update_period_s),
            calibrated=field(lambda c: c.gain is not None, dtype=torch.bool))


def default_calibrations(
        profile_names: Sequence[str]) -> Dict[str, CalibrationRecord]:
    """Nominal records from the catalog (no gain/offset: uncalibrated),
    one per distinct profile name."""
    return {name: nominal_record("stream", _profiles.get(name))
            for name in sorted(set(profile_names))}
