"""gpu_uuid → dense device id mapping with hot-add semantics.

The counterpart of :mod:`repro.collect.registry`: host Python, one dict
lookup a sample, as the reference does it.

Every array in the monitor stack is indexed by a dense ``[0, N)`` device
id; real telemetry is keyed by opaque GPU uuids that appear whenever a
node joins the fleet.  :class:`DeviceRegistry` owns that mapping and the
policy for uuids it has never seen:

* ``on_unknown="add"`` (lenient, the default) — assign the next dense
  id in first-seen order; the collector pipeline then grows the monitor
  to match (see :meth:`~repro_torch.core.stream.monitor.MonitorService.grow`).
* ``on_unknown="reject"`` (frozen fleet) — map to ``-1`` and count;
  downstream a ``MonitorService(strict_ids=False)`` rejects-and-counts
  those samples, so nothing raises but nothing is silently absorbed
  into the wrong device either.
* ``on_unknown="raise"`` (strict) — :class:`UnknownDeviceError`.

First-seen order is the registry's *contract*: replaying the same log
through a fresh registry reproduces the same uuid→id mapping, which is
what makes collector replays comparable run to run.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

_POLICIES = ("add", "reject", "raise")


class UnknownDeviceError(KeyError):
    """A uuid not in the registry under ``on_unknown="raise"``."""


class DeviceRegistry:
    """Dense-id registry over gpu uuids (see module doc).

    Usage::

        reg = DeviceRegistry()                    # lenient hot-add
        ids = reg.resolve(batch.uuid, t=batch.t)  # [K] int64 (-1 = rejected)
        reg.n_devices                             # grows in first-seen order
    """

    def __init__(self, uuids: Iterable[str] = (), *,
                 on_unknown: str = "add"):
        if on_unknown not in _POLICIES:
            raise ValueError(f"unknown on_unknown policy '{on_unknown}'; "
                             f"known: {', '.join(_POLICIES)}")
        self.on_unknown = on_unknown
        self._ids: Dict[str, int] = {}
        self.uuids: List[str] = []
        self.first_seen_t: List[float] = []
        self.n_rejected = 0
        for u in uuids:
            self.add(str(u))

    @property
    def n_devices(self) -> int:
        return len(self.uuids)

    def __contains__(self, uuid: str) -> bool:
        return uuid in self._ids

    def id_of(self, uuid: str) -> int:
        """The dense id of a known uuid (KeyError otherwise)."""
        return self._ids[uuid]

    def add(self, uuid: str, t: float = np.nan) -> int:
        """Register a uuid (idempotent); returns its dense id."""
        i = self._ids.get(uuid)
        if i is not None:
            return i
        i = len(self.uuids)
        self._ids[uuid] = i
        self.uuids.append(uuid)
        self.first_seen_t.append(float(t))
        return i

    def resolve(self, uuids: np.ndarray,
                t: Optional[np.ndarray] = None) -> np.ndarray:
        """Map a batch of uuids to dense ids [K] int64, applying the
        unknown-uuid policy.  ``t`` (optional, [K]) stamps each
        hot-added uuid's ``first_seen_t`` with its first sample time.
        """
        k = len(uuids)
        out = np.empty(k, dtype=np.int64)
        ids = self._ids
        for j in range(k):
            u = uuids[j]
            i = ids.get(u)
            if i is None:
                if self.on_unknown == "add":
                    i = self.add(u, np.nan if t is None else float(t[j]))
                elif self.on_unknown == "reject":
                    self.n_rejected += 1
                    i = -1
                else:
                    raise UnknownDeviceError(
                        f"uuid '{u}' not in the frozen registry "
                        f"({self.n_devices} known devices)")
            out[j] = i
        return out

    def summary(self) -> dict:
        return {
            "n_devices": self.n_devices,
            "on_unknown": self.on_unknown,
            "n_rejected": self.n_rejected,
            "uuids": list(self.uuids),
            "first_seen_t": [float(x) for x in self.first_seen_t],
        }
