"""Counter-based keyed random streams (Philox4x32-10) in plain PyTorch.

The port's counterpart of the per-device lock-step streams of
:mod:`repro.core.engine_backend.vecrng`.  It does not reproduce numpy's
PCG64 bit for bit; it gives every draw an address instead of a place in a
sequence.  A draw is a function of its key (a 64-bit seed) and its counter
``(row, slot, tag, 0)``: the fleet row of a device, the index of the draw
within that device's stream, and the stream's tag (reading noise, poll
jitter, §5 start offsets, the meter's ADC noise, a square wave's period
jitter, the micro-benchmarks' repetition seeds, a scenario's shape).  So
a device's draws depend on neither which other devices share a call, nor
how a fleet is cut into slabs, nor the device the tensors live on.

Philox4x32-10 is written in int64 torch ops.  torch has no uint64
arithmetic and signed overflow must not be relied on, so each 32×32-bit
product is split into 16-bit halves: every intermediate stays below 2^49
and the integer words are equal on the CPU and the card by construction.
Uniforms take 53 bits from two 32-bit words; normals come by Box–Muller
in float64 from the four words of one block.  Random123's known answers
pin the generator (``tests/test_torch_keyed_rng.py``).
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch

F64 = torch.float64
I64 = torch.int64

#: stream tags: word 2 of the counter
TAG_NOISE = 1       # SensorBank / OnboardSensor reading jitter
TAG_JITTER = 2      # poll-time jitter
TAG_TRIAL = 3       # §5 trial start offsets, keyed by protocol seed
TAG_ADC = 4         # GroundTruthMeter ADC noise
TAG_PERIOD = 5      # square-wave period jitter, keyed by the wave's seed
TAG_REPEAT = 6      # micro-benchmark repetition seeds
TAG_SCENARIO = 7    # scenario shapes, keyed by each device's scenario seed

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_ROUNDS = 10
_TWO_M53 = 2.0 ** -53

Key = Union[int, torch.Tensor]


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``m · x`` for a 32-bit constant ``m``
    and 32-bit words ``x`` held in int64: ``x`` is split into 16-bit
    halves so no product reaches 2^49."""
    p_lo = (x & 0xFFFF) * m
    p_hi = (x >> 16) * m
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK


def _key_words(key: Key) -> Tuple[Key, Key]:
    """The two 32-bit key words of ``key`` taken modulo 2^64 (an int64
    tensor's two's complement, or a Python int of any sign)."""
    if isinstance(key, torch.Tensor):
        return key & _MASK, (key >> 32) & _MASK
    key = int(key) % (1 << 64)
    return key & _MASK, key >> 32


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
               c3: torch.Tensor, k0: Key, k1: Key
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Philox4x32-10 of counter words ``c0..c3`` under key words
    ``k0, k1`` (uint32 values held in int64 tensors or ints, broadcast
    together); returns the four output words as int64 tensors."""
    for r in range(_ROUNDS):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def check_index(name: str, hi: int) -> None:
    """Raise unless indices up to ``hi`` fit a 32-bit counter word (the
    callers check on the host, so a draw on the card never syncs)."""
    if hi > _MASK:
        raise ValueError(f"keyed stream {name} index {hi} does not fit "
                         "32 bits")


def _block(key: Key, rows: torch.Tensor, slots: torch.Tensor, tag: int):
    """The Philox block at counter ``(rows, slots, tag, 0)`` (broadcast
    together; non-negative and below 2^32, see :func:`check_index`) under
    ``key``."""
    rows = torch.as_tensor(rows, dtype=I64)
    slots = torch.as_tensor(slots, dtype=I64, device=rows.device)
    rows, slots = torch.broadcast_tensors(rows, slots)
    k0, k1 = _key_words(key)
    if isinstance(k0, torch.Tensor):
        k0, k1 = k0.to(rows.device), k1.to(rows.device)
    c2 = torch.full_like(rows, int(tag))
    return philox4x32(rows, slots, c2, torch.zeros_like(rows), k0, k1)


def _unit(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """A float64 in [0, 1) from 53 bits of two 32-bit words (exact)."""
    return ((hi << 21) | (lo >> 11)).to(F64) * _TWO_M53


def uniform(key: Key, rows: torch.Tensor, slots: torch.Tensor,
            tag: int) -> torch.Tensor:
    """U[0, 1) float64 draws at counters ``(rows, slots, tag)`` under
    ``key`` (an int, or an int64 tensor broadcast against the counters),
    on the counters' device."""
    x0, x1, _, _ = _block(key, rows, slots, tag)
    return _unit(x0, x1)


def normal(key: Key, rows: torch.Tensor, slots: torch.Tensor,
           tag: int) -> torch.Tensor:
    """Standard normal float64 draws at counters ``(rows, slots, tag)``
    under ``key``: Box–Muller, ``sqrt(-2 ln(1 - u1)) · cos(2π u2)``, with
    ``u1`` and ``u2`` from the block's first and last word pairs."""
    x0, x1, x2, x3 = _block(key, rows, slots, tag)
    u1 = _unit(x0, x1)
    u2 = _unit(x2, x3)
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(
        (2.0 * math.pi) * u2)
