"""Bytes and float64 operations of the monitor's two ingest kernels and of
one ingested slab, from their shapes.

The kernels' counts follow their argument lists (``csrc/stream_ingest.cu``,
``csrc/stream_ingest_grid.cu``): each input read once, each output written
once.  The flat kernel takes its groups from ``start_idx``/``end_idx`` and
reads neither ``seg`` nor ``first``.
"""
from __future__ import annotations

F64 = I64 = 8
BOOL = 1

#: float64 operations a sample: the sample's arithmetic (correction,
#: hold, two energy flavours, two window flavours, run tracking), the two
#: scans and the row reductions, a division counted as one
OPS_PER_SAMPLE = 35

#: per-device inputs of either kernel besides the samples: prev_t, prev_v,
#: run_t, gain, offset, tshift, win_a, win_b, max_hold, env_lo, env_hi
#: (float64), n_changes (int64) and has_prev (bool)
_STATE_IN = 11 * F64 + I64 + BOOL


def grid_kernel_bytes(d: int, m: int) -> int:
    """``stream_ingest_grid`` over ``d`` devices by ``m`` shared times:
    ts [m] and v [d, m] in; per device the state above in and twelve
    8-byte results out (new_v, new_run_t, new_n_changes, four energies,
    three sums, max |vc|, n_out); per sample cum_e, cum_ec, run_dur
    (float64) and run_rec (bool) out."""
    ins = m * F64 + d * m * F64 + d * _STATE_IN
    outs = d * 12 * F64 + d * m * (3 * F64 + BOOL)
    return ins + outs


def grid_kernel_ops(d: int, m: int) -> int:
    return OPS_PER_SAMPLE * d * m


def flat_kernel_bytes(k: int, u: int) -> int:
    """``stream_ingest`` over ``k`` samples in ``u`` device groups: t, v
    [k] and start_idx, end_idx [u] in, the per-group state above in;
    fourteen per-group results out (new_t, new_v, new_run_t,
    new_n_changes, counts, four energies, three sums, max |vc|, n_out);
    per sample cum_e, cum_ec, vc, run_dur (float64) and run_rec (bool)."""
    ins = k * 2 * F64 + u * 2 * I64 + u * _STATE_IN
    outs = u * 14 * F64 + k * (4 * F64 + BOOL)
    return ins + outs


def flat_kernel_ops(k: int) -> int:
    return OPS_PER_SAMPLE * k


#: the monitor's per-device state (``DeviceState``): fourteen 8-byte
#: fields and ``has``
DEVICE_STATE_BYTES = 14 * 8 + BOOL


def ring_bytes(slots: int) -> int:
    """One device's ring: t, v, e_raw, e_corr a slot, and n_written."""
    return slots * 4 * F64 + I64


def slab_min_bytes(n_samples: int, n_devices: int, bytes_per_sample: int,
                   ring_slots: int, shared_times: int = 0) -> int:
    """The least a slab's ingest must move: its samples read once
    (``bytes_per_sample``: 8 for a grid reading, 24 for a flat (id, t, v)
    triple; ``shared_times`` grid times besides), and each per-device state
    field of its devices, the ring's included, read once and written
    once."""
    state = n_devices * (DEVICE_STATE_BYTES + ring_bytes(ring_slots))
    return n_samples * bytes_per_sample + shared_times * F64 + 2 * state
