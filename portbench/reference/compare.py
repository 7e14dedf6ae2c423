"""The comparisons that decide ``correct``: each gives one number, which
the cell's limits file (``limits/<cell>.json``) holds to a limit."""
from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

F64 = torch.float64


def rel_gap(prog, ref) -> float:
    """The widest gap between the program's value and the reference's, as
    a share of the larger of that entry's reference magnitude and the
    median entry's.  Where the reference is finite and the program is
    not, the gap is infinite."""
    p = torch.as_tensor(prog).detach().to("cpu", F64).reshape(-1)
    r = torch.as_tensor(ref).detach().to("cpu", F64).reshape(-1)
    if p.shape != r.shape:
        return math.inf
    ok = torch.isfinite(r)
    if not bool(ok.any()):
        return 0.0
    p, r = p[ok], r[ok]
    if not bool(torch.isfinite(p).all()):
        return math.inf
    scale = torch.clamp_min(r.abs(), float(r.abs().median()))
    scale = torch.where(scale > 0, scale, 1.0)
    return float(((p - r).abs() / scale).max())


def mismatches(prog, ref) -> int:
    """Entries that differ, NaN matching NaN."""
    p = torch.as_tensor(prog).detach().to("cpu")
    r = torch.as_tensor(ref).detach().to("cpu")
    if p.shape != r.shape:
        return max(p.numel(), r.numel(), 1)
    if p.dtype.is_floating_point or r.dtype.is_floating_point:
        p, r = p.to(F64), r.to(F64)
        same = (p == r) | (torch.isnan(p) & torch.isnan(r))
    else:
        same = p == r
    return int((~same).sum())


def worst(gaps: Iterable[float]) -> float:
    return max(gaps, default=0.0)


#: the monitor's exact state: counts, times and held readings
EXACT = ("n_samples", "n_dup", "n_late", "n_changes", "first_t", "last_t",
         "last_v", "has")
_MOMENT_KEYS = ("n_devices", "mean_err", "std_err", "mean_abs_err",
                "worst_abs")


def monitor(prog: dict, ref: dict) -> Dict[str, float]:
    """The monitor's numbers: exact state and counters (mismatching
    entries), energies, window energies, update-period estimates, the
    label moments and the ring's ``energy_between``."""
    exact = sum(mismatches(prog[k], ref[k]) for k in EXACT)
    exact += sum(int(prog["counters"].get(k) != v)
                 for k, v in ref["counters"].items())
    pe, re_ = (torch.as_tensor(x).to("cpu", F64)
               for x in (prog["period_est"], ref["period_est"]))
    exact += int((torch.isnan(pe) != torch.isnan(re_)).sum())
    mom = []
    for label, rs in ref["moments"].items():
        ps = prog["moments"].get(label)
        if ps is None:
            exact += 1
            continue
        exact += int(ps["n_devices"] != rs["n_devices"])
        mom += [abs(ps[k] - rs[k]) / max(abs(rs[k]), 1e-300)
                for k in _MOMENT_KEYS[1:]]
    return {
        "state_mismatches": float(exact),
        "energy_gap": worst(rel_gap(prog[k], ref[k])
                            for k in ("energy_j", "energy_corr_j")),
        "window_gap": worst(rel_gap(prog[k], ref[k])
                            for k in ("win_j", "win_corr_j")),
        "period_gap": rel_gap(pe, re_),
        "moments_gap": worst(mom),
        "ring_gap": worst(rel_gap(prog[k], ref[k])
                          for k in ("between_raw", "between_corr")),
    }
