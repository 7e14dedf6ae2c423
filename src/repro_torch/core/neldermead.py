"""Dependency-free Nelder–Mead simplex minimiser.

The port's own copy of :mod:`repro.core.neldermead` (numpy only, step for
step): the paper fits the boxcar-window size by minimising an MSE loss
with Nelder–Mead (§4.3 step 6).  Box bounds are applied by clipping at
evaluation time.  The simplex loop is scalar host control flow; the
objective may evaluate on the card and return a float.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class NMResult:
    x: np.ndarray
    fun: float
    nit: int
    nfev: int
    converged: bool


def minimize(f: Callable[[np.ndarray], float],
             x0: Sequence[float],
             *,
             initial_step: float | Sequence[float] = 0.25,
             bounds: Optional[Sequence[tuple[float, float]]] = None,
             xatol: float = 1e-6,
             fatol: float = 1e-9,
             max_iter: int = 500) -> NMResult:
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.size
    lo = hi = None
    if bounds is not None:
        lo = np.asarray([b[0] for b in bounds], dtype=np.float64)
        hi = np.asarray([b[1] for b in bounds], dtype=np.float64)

    def clip(x: np.ndarray) -> np.ndarray:
        if lo is None:
            return x
        return np.clip(x, lo, hi)

    nfev = 0

    def feval(x: np.ndarray) -> float:
        nonlocal nfev
        nfev += 1
        return float(f(clip(x)))

    # initial simplex
    steps = np.broadcast_to(np.asarray(initial_step, dtype=np.float64), (n,))
    simplex = [x0.copy()]
    for i in range(n):
        v = x0.copy()
        v[i] += steps[i] if steps[i] != 0 else 0.05
        simplex.append(v)
    simplex = np.asarray(simplex)
    fvals = np.asarray([feval(v) for v in simplex])

    alpha, gamma, rho, sigma = 1.0, 2.0, 0.5, 0.5
    it = 0
    for it in range(1, max_iter + 1):
        order = np.argsort(fvals)
        simplex, fvals = simplex[order], fvals[order]
        if (np.max(np.abs(simplex[1:] - simplex[0])) <= xatol
                and np.max(np.abs(fvals[1:] - fvals[0])) <= fatol):
            return NMResult(clip(simplex[0]), fvals[0], it, nfev, True)

        centroid = simplex[:-1].mean(axis=0)
        xr = centroid + alpha * (centroid - simplex[-1])
        fr = feval(xr)
        if fvals[0] <= fr < fvals[-2]:
            simplex[-1], fvals[-1] = xr, fr
        elif fr < fvals[0]:
            xe = centroid + gamma * (xr - centroid)
            fe = feval(xe)
            if fe < fr:
                simplex[-1], fvals[-1] = xe, fe
            else:
                simplex[-1], fvals[-1] = xr, fr
        else:
            xc = centroid + rho * (simplex[-1] - centroid)
            fc = feval(xc)
            if fc < fvals[-1]:
                simplex[-1], fvals[-1] = xc, fc
            else:  # shrink
                for i in range(1, n + 1):
                    simplex[i] = simplex[0] + sigma * (simplex[i] - simplex[0])
                    fvals[i] = feval(simplex[i])

    order = np.argsort(fvals)
    return NMResult(clip(simplex[order][0]), fvals[order][0], it, nfev, False)


def minimize_scalar(f: Callable[[float], float], x0: float, *,
                    lo: float, hi: float, initial_step: float | None = None,
                    max_iter: int = 200) -> NMResult:
    """1-D convenience wrapper (what the boxcar fit uses)."""
    step = initial_step if initial_step is not None else 0.25 * (hi - lo)
    res = minimize(lambda v: f(float(v[0])), [x0], initial_step=step,
                   bounds=[(lo, hi)], xatol=1e-7, max_iter=max_iter)
    return res
