"""Make the port draw the reference's random numbers, for the tests that
hold the port against the JAX package's numpy tier.

The port draws reading noise, §5 start offsets, ADC noise, square-wave
period jitter and the boxcar fit's repetition seeds from its keyed
Philox stream (``repro_torch.engine_backend.keyed_rng``), the reference
from per-seed numpy streams.  ``substitute`` and
``substitute_microbench`` replace the port's draw functions with the
reference's, so the same numbers go through both packages.
"""
import dataclasses

import numpy as np
import torch

from repro.core import fleet_engine as rfe
from repro.core import sensor as rsensor
from repro.core.engine_backend.vecrng import VecStreams
from repro_torch.core import fleet_engine as fe
from repro_torch.core import ground_truth as gt
from repro_torch.core import load as loads
from repro_torch.core import meter as pm
from repro_torch.core import microbench as mb


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def reference_starts(seeds, n_trials, device="cpu"):
    """The reference's §5 start offsets: ``n_trials`` uniforms per seed
    from its ``default_rng(seed)`` stream."""
    seeds = np.asarray(seeds)
    return torch.as_tensor(VecStreams(seeds).uniform_block(
        0.0, 1.0, np.full(len(seeds), n_trials)), device=device)


def reference_adc(keys, m):
    """The reference meter's ADC noise: ``m`` normals per key from its
    ``default_rng(key)`` stream."""
    return torch.stack([torch.as_tensor(
        np.random.default_rng(int(k)).standard_normal(m))
        for k in keys.cpu()]).to(keys.device)


def substitute(monkeypatch, ref_bank_for, adc=False):
    """Route every port bank's reading noise to the reference bank
    ``ref_bank_for(bank)``, whose rows are the port bank's rows in order,
    and the §5 start offsets (and, with ``adc``, the meter's ADC noise) to
    the reference's."""
    def noise(self, m, first, count):
        ref = ref_bank_for(self)
        return torch.as_tensor(ref._noise(m, _np(first), _np(count)),
                               device=self.device)

    monkeypatch.setattr(fe.SensorBank, "_noise", noise)
    monkeypatch.setattr(pm, "_trial_starts", reference_starts)
    if adc:
        monkeypatch.setattr(gt, "_adc_noise", reference_adc)


def reference_bank(bank):
    """The reference bank whose rows draw the reading noise of the port
    bank's rows: per-device ``default_rng(seed + row + 1)`` streams (a
    reference sensor of seed ``s`` is the port bank of seed ``s``, row
    0)."""
    return rfe.SensorBank([rsensor.SensorProfile(**dataclasses.asdict(p))
                           for p in bank.profiles],
                          seeds=bank.seed + bank._rows)


def reference_period_jitter(seed, n_cycles, jitter_s):
    """The reference square wave's period jitter: one
    ``default_rng(seed).uniform(-jitter_s, jitter_s)`` per cycle."""
    rng = np.random.default_rng(seed)
    return [float(rng.uniform(-jitter_s, jitter_s)) for _ in range(n_cycles)]


def reference_repetition_seeds(seed, n):
    """The reference boxcar fit's repetition seeds: one
    ``default_rng(seed).integers(1 << 31)`` per repetition."""
    rng = np.random.default_rng(seed)
    return [int(rng.integers(1 << 31)) for _ in range(n)]


def substitute_microbench(monkeypatch):
    """Every draw of the port's characterisation as the reference's: the
    reading noise, ADC noise, period jitter and repetition seeds."""
    substitute(monkeypatch, reference_bank, adc=True)
    monkeypatch.setattr(loads, "_period_jitter", reference_period_jitter)
    monkeypatch.setattr(mb, "_repetition_seeds", reference_repetition_seeds)
