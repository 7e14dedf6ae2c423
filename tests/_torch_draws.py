"""Make the port draw the reference's random numbers, for the tests that
hold the port against the JAX package's numpy tier.

The port draws reading noise, §5 start offsets and ADC noise from its
keyed Philox stream (``repro_torch.engine_backend.keyed_rng``), the
reference from per-seed numpy streams.  ``substitute`` replaces the
port's draw functions with the reference's, so the same numbers go
through both packages.
"""
import numpy as np
import torch

from repro.core.engine_backend.vecrng import VecStreams
from repro_torch.core import fleet_engine as fe
from repro_torch.core import ground_truth as gt
from repro_torch.core import meter as pm


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
