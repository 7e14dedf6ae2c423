"""Tensor containers shared by the engine ops.

The counterparts of :mod:`repro.core.engine_backend.pytrees`: plain
``NamedTuple``s of tensors with the same fields and invariants.  They
carry no behaviour; the ops in :mod:`.torch_backend` are functions over
them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TimelineArrays(NamedTuple):
    """Padded piecewise-constant traces: ``R`` rows of up to ``S`` segments.

    ``edges`` is ``[R, S+1]`` (non-decreasing per row, padding repeats the
    final valid edge), ``powers`` ``[R, S]`` (padding holds the row's idle
    power), ``idle_w`` and ``n_segs`` are ``[R]``.
    """

    edges: torch.Tensor
    powers: torch.Tensor
    idle_w: torch.Tensor
    n_segs: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.edges.shape[0]

    @property
    def t_start(self) -> torch.Tensor:
        return self.edges[:, 0]

    @property
    def t_end(self) -> torch.Tensor:
        return self.edges[:, -1]


class ReadingSchedule(NamedTuple):
    """A fleet's published-reading schedule as padded ``[N, M]`` tensors.

    ``ticks`` holds every device's publication instants (``phase + T*k``,
    leading/trailing slots masked rather than filtered); ``first``/``last``
    are each device's first/last valid slot, ``k0`` the tick index of
    slot 0.
    """

    ticks: torch.Tensor
    first: torch.Tensor
    last: torch.Tensor
    k0: torch.Tensor
    phase: torch.Tensor
    update_period_s: torch.Tensor
