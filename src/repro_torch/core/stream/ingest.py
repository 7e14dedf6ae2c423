"""The streaming monitor's ingest core: mutable state + the hot path.

The counterpart of :mod:`repro.core.stream.ingest`.  :class:`IngestCore`
owns the monitor's online state — :class:`~.state.DeviceState`, the
recent-sample ring, the period histograms, all on the card — plus the
per-label reading moments (host floats), and folds slabs in with the two
entry points: ``ingest`` for arbitrary slabs (the CUDA ``stream_ingest``
kernel) and ``ingest_grid`` for clean rectangular slabs (the CUDA
``stream_ingest_grid`` kernel).  It serves no queries: readers go through
the :class:`~.snapshot.MonitorSnapshot` the façade publishes.

Every slab that lands bumps :attr:`epoch`; the samples a slab's prep
drops are counted under ``ingest.dropped.{rejected,invalid,duplicates,
late}``.  With a :class:`~.health.HealthPolicy` the health machine runs
at slab boundaries (at most every ``health_every_s`` of stream time) in
its own phase span ``ingest.health``;
:meth:`IngestCore.grow` widens the monitor mid-stream; the state's field
set is :mod:`.schema`'s, which checkpoints and ``nbytes()`` walk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.common import spans
from repro_torch.core.fleet_engine import StreamingMoments
from repro_torch.core.stream import schema
from repro_torch.core.stream.estimators import (OnlinePeriodEstimator,
                                                StreamCorrections)
from repro_torch.core.stream.health import HealthPolicy, HealthTracker
from repro_torch.core.stream.state import DeviceState, IngestBuffer
from repro_torch.kernels.stream_group import stream_group
from repro_torch.kernels.stream_ingest import stream_ingest
from repro_torch.kernels.stream_ingest_grid import stream_ingest_grid

F64, I64 = torch.float64, torch.int64
_INTEGRATIONS = ("rectangle", "trapezoid")


@dataclasses.dataclass(frozen=True)
class IngestReport:
    """What one ``ingest`` call did with its slab."""

    accepted: int
    duplicates: int
    late: int
    invalid: int
    n_devices: int      # distinct devices that contributed samples
    rejected: int = 0   # out-of-range device ids (strict_ids=False only)


def _per_device(x, n: int, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64, device=dev).expand(n).clone()


class IngestCore:
    """Mutable online state + slab ingestion.  Arguments are those of
    :class:`~repro_torch.core.stream.monitor.MonitorService`, which
    documents them."""

    def __init__(self, n_devices: int, *,
                 corrections: Optional[StreamCorrections] = None,
                 labels=None,
                 integration: str = "rectangle",
                 max_hold_s=None,
                 envelope_w: Optional[tuple] = None,
                 ring_slots: int = 8,
                 period_bins: int = 24,
                 min_runs: int = 3,
                 silent_after_s: Optional[float] = None,
                 drift_tau_s: float = 30.0,
                 drift_rel: float = 0.25,
                 drift_abs_w: float = 5.0,
                 strict_ids: bool = True,
                 health: Optional[HealthPolicy] = None,
                 health_every_s: float = 0.0,
                 device: DeviceLike = "cuda"):
        if n_devices < 1:
            raise ValueError("need at least one device")
        if integration not in _INTEGRATIONS:
            raise ValueError(f"unknown integration '{integration}'; "
                             f"known: {', '.join(_INTEGRATIONS)}")
        self.device = dev = resolve_device(device)
        n = int(n_devices)
        self.n_devices = n
        self.corrections = (corrections.to(dev) if corrections is not None
                            else StreamCorrections.identity(n, device=dev))
        if self.corrections.n_devices != n:
            raise ValueError(
                f"corrections cover {self.corrections.n_devices} devices, "
                f"monitor has {n}")
        if labels is None:
            self.labels = np.full(n, "all", dtype=object)
        else:
            self.labels = np.asarray(labels, dtype=object)
            if self.labels.shape != (n,):
                raise ValueError(f"labels must be [{n}], "
                                 f"got {self.labels.shape}")
        self._set_label_codes()
        self.trapezoid = integration == "trapezoid"
        if max_hold_s is None:
            self._max_hold = torch.full((n,), float("inf"), dtype=F64,
                                        device=dev)
        else:
            self._max_hold = _per_device(max_hold_s, n, dev)
            if bool((self._max_hold <= 0.0).any()):
                raise ValueError("max_hold_s must be positive")
        if envelope_w is None:
            self._env_lo = torch.full((n,), -float("inf"), dtype=F64,
                                      device=dev)
            self._env_hi = torch.full((n,), float("inf"), dtype=F64,
                                      device=dev)
        else:
            lo, hi = envelope_w
            self._env_lo = _per_device(lo, n, dev)
            self._env_hi = _per_device(hi, n, dev)

        self.state = DeviceState.zeros(n, dev)
        self.ring = IngestBuffer(n, ring_slots, dev)
        self.periods = OnlinePeriodEstimator(n, n_bins=period_bins,
                                             min_runs=min_runs, device=dev)
        # windows disabled until registered: [+inf, -inf] selects nothing
        self._win_a = torch.full((n,), float("inf"), dtype=F64, device=dev)
        self._win_b = torch.full((n,), -float("inf"), dtype=F64, device=dev)

        self.silent_after_s = silent_after_s
        self.drift_tau_s = float(drift_tau_s)
        self.drift_rel = float(drift_rel)
        self.drift_abs_w = float(drift_abs_w)
        self._moments: Dict[str, StreamingMoments] = {}
        self._n_invalid = 0
        self.strict_ids = bool(strict_ids)
        self._n_rejected = 0
        # with a policy, the health machine runs at slab boundaries, at
        # most every health_every_s of stream time
        self.health_policy = health
        self.health = (HealthTracker.zeros(n, dev) if health is not None
                       else None)
        self.health_every_s = float(health_every_s)
        self._next_health_t = -np.inf
        self.epoch = 0

    def _set_label_codes(self) -> None:
        """Integer label codes (new tensors) from :attr:`labels`: they keep
        strings off the hot path."""
        names, codes = np.unique(self.labels.astype(str),
                                 return_inverse=True)
        self._label_names = [str(x) for x in names]
        self._label_codes = torch.as_tensor(codes.astype(np.int64),
                                            device=self.device)

    # -- configuration ----------------------------------------------------
    def set_windows(self, a, b) -> None:
        """Register per-device measurement windows ``[a_i, b_i]`` (the §5
        execution windows).  Window energy accumulates sample by sample,
        so windows must be set before the first sample arrives."""
        if int(self.state.n_samples.sum()) > 0:
            raise RuntimeError("windows must be registered before the "
                               "first ingest (accumulation is not "
                               "retroactive)")
        n, dev = self.n_devices, self.device
        self._win_a = _per_device(a, n, dev)
        self._win_b = _per_device(b, n, dev)
        self.epoch += 1

    def nbytes(self) -> int:
        """Resident bytes of the state that scales with fleet size, summed
        through the schema registries that checkpoints walk: a state
        field added without a schema update fails here first."""
        return (self.state.nbytes() + self.ring.nbytes()
                + self.periods.nbytes()
                + (self.health.nbytes() if self.health is not None else 0))

    def grow(self, n_new: int, *,
             corrections: Optional[StreamCorrections] = None,
             labels=None) -> None:
        """Widen the monitor to ``n_new`` devices mid-stream, leaving what
        is accumulated untouched: afterwards every state tensor equals what
        a monitor built at the full width from the start would hold, the
        appended rows in their zero state.  ``corrections``/``labels``
        cover the appended ``n_new - n_devices`` rows (identity
        corrections and the ``"all"`` label by default); their windows
        start disabled and their hold and envelope unlimited, a fresh
        monitor's defaults.  Every per-device tensor is replaced by a new
        one, never written into, so a held snapshot keeps its answers;
        the epoch bumps once."""
        n_old, dev = self.n_devices, self.device
        n_new = int(n_new)
        if n_new < n_old:
            raise ValueError(f"cannot shrink a monitor: {n_old} -> {n_new}")
        if n_new == n_old:
            return
        n_add = n_new - n_old
        tail_corr = (corrections.to(dev) if corrections is not None
                     else StreamCorrections.identity(n_add, device=dev))
        if tail_corr.n_devices != n_add:
            raise ValueError(f"tail corrections cover "
                             f"{tail_corr.n_devices} devices, growing "
                             f"by {n_add}")
        if labels is None:
            tail_labels = np.full(n_add, "all", dtype=object)
        else:
            tail_labels = np.asarray(labels, dtype=object)
            if tail_labels.shape != (n_add,):
                raise ValueError(f"tail labels must be [{n_add}], "
                                 f"got {tail_labels.shape}")
        # per-device state walked through the schema registries (before
        # anything changes), so a field added without growth support
        # fails loudly and leaves the monitor as it was
        old_state = schema.check_registry(
            self.state, schema.DEVICE_STATE_FIELDS, "DeviceState")
        old_ring = schema.check_registry(
            self.ring, schema.RING_FIELDS, "IngestBuffer",
            optional=schema.RING_SLOT_FIELDS)
        old_health = (schema.check_registry(
            self.health, schema.HEALTH_FIELDS, "HealthTracker")
            if self.health is not None else {})

        self.corrections = StreamCorrections(**{
            f.name: torch.cat([getattr(self.corrections, f.name),
                               getattr(tail_corr, f.name)])
            for f in dataclasses.fields(StreamCorrections)})
        self.labels = np.concatenate([self.labels, tail_labels])
        self._set_label_codes()
        pad = DeviceState.zeros(n_add, dev)
        self.state = DeviceState(**{k: torch.cat([v, getattr(pad, k)])
                                    for k, v in old_state.items()})
        ring_pad = IngestBuffer(n_add, self.ring.slots, dev)
        for k, v in old_ring.items():
            setattr(self.ring, k, torch.cat([v, getattr(ring_pad, k)]))
        per = self.periods
        per.counts = torch.cat([per.counts, torch.zeros(
            (n_add, per.counts.shape[1]), dtype=I64, device=dev)])
        per.sums = torch.cat([per.sums, torch.zeros(
            (n_add, per.sums.shape[1]), dtype=F64, device=dev)])
        if self.health is not None:
            health_pad = HealthTracker.zeros(n_add, dev)
            for k, v in old_health.items():
                setattr(self.health, k,
                        torch.cat([v, getattr(health_pad, k)]))

        # configuration: the tail takes a fresh monitor's defaults
        def cat(x, fill):
            return torch.cat([x, torch.full((n_add,), fill, dtype=F64,
                                            device=dev)])

        inf = float("inf")
        self._max_hold = cat(self._max_hold, inf)
        self._env_lo = cat(self._env_lo, -inf)
        self._env_hi = cat(self._env_hi, inf)
        self._win_a = cat(self._win_a, inf)
        self._win_b = cat(self._win_b, -inf)
        self.n_devices = n_new
        self.epoch += 1

    # -- ingestion --------------------------------------------------------
    def _check_ids(self, dev: torch.Tensor) -> Optional[torch.Tensor]:
        """None when every id is in range; else the in-range mask (or a
        raise, with ``strict_ids``)."""
        ok = (dev >= 0) & (dev < self.n_devices)
        with spans.read("ingest.ids"):
            if bool(ok.all()):
                return None
        if self.strict_ids:
            raise ValueError("device id out of range")
        return ok

    def ingest(self, dev, t, v) -> IngestReport:
        """Fold one slab of raw poll samples into the online state.

        ``dev`` [K] int device ids, ``t`` [K] sample times, ``v`` [K] raw
        readings (tensors or arrays; moved to the monitor's device) — any
        order; duplicates, late and non-finite samples are dropped and
        counted.  Out-of-range ids raise, or with ``strict_ids=False`` are
        rejected and counted."""
        with spans.span("ingest.flat"):
            return self._ingest(dev, t, v)

    def _ingest(self, dev, t, v) -> IngestReport:
        d0 = self.device
        st = self.state
        with spans.span("ingest.prep"):
            dev = torch.as_tensor(dev, device=d0).to(I64).reshape(-1)
            t = torch.as_tensor(t, dtype=F64, device=d0).reshape(-1)
            v = torch.as_tensor(v, dtype=F64, device=d0).reshape(-1)
            if not (dev.shape == t.shape == v.shape):
                raise ValueError(f"shape mismatch: dev {tuple(dev.shape)}, "
                                 f"t {tuple(t.shape)}, v {tuple(v.shape)}")
            # ids and finiteness checked, sorted by (device, t, arrival),
            # duplicates and late samples dropped and counted, baselined,
            # grouped by device: one kernel pipeline on the card
            g = stream_group(dev, t, v, st.has, st.last_t, st.n_dup,
                             st.n_late, self.corrections.baseline_w,
                             self.strict_ids)
            n_rej = g.rejected
            self._n_rejected += n_rej
            self._count_drops(n_rej, g.invalid, g.duplicates, g.late)
            if g.in_range == 0:
                if n_rej:               # counters mutated: publish fresh
                    self.epoch += 1
                return IngestReport(0, 0, 0, 0, 0, n_rej)
            # even an all-dropped slab mutates counters: publish fresh
            self.epoch += 1
            n_invalid, n_dup, n_late = g.invalid, g.duplicates, g.late
            self._n_invalid += n_invalid
            dev, t, v, seg, first, start_idx, end_idx, u_dev = g[:8]
            k = dev.numel()
            if k == 0:
                return IngestReport(0, n_dup, n_late, n_invalid, 0, n_rej)

            had = st.has[u_dev]
            c = self.corrections
            run_t_in = torch.where(had, st.run_t[u_dev], t[start_idx])
        with spans.span("ingest.kernel"):
            out = stream_ingest(
                t, v, seg, first, start_idx, end_idx,
                st.last_t[u_dev], st.last_v[u_dev], had, run_t_in,
                st.n_changes[u_dev], c.gain[u_dev], c.offset_w[u_dev],
                c.time_shift_s[u_dev], self._win_a[u_dev], self._win_b[u_dev],
                self._max_hold[u_dev], self._env_lo[u_dev],
                self._env_hi[u_dev], self.trapezoid)

        with spans.span("ingest.fold"):
            # ring snapshots see running totals *before* this slab is folded
            if self.ring.slots:
                ordinal = torch.arange(k, device=d0) - start_idx[seg]
                self.ring.write(dev, ordinal, out.counts[seg], t, v,
                                st.energy_j[u_dev][seg] + out.cum_e,
                                st.energy_corr_j[u_dev][seg] + out.cum_ec,
                                u_dev, out.counts)
            else:
                self.ring.n_written[u_dev] += out.counts

            old_last_t = st.last_t[u_dev]
            st.first_t[u_dev] = torch.where(had, st.first_t[u_dev],
                                            t[start_idx])
            st.last_t[u_dev] = out.new_t
            st.last_v[u_dev] = out.new_v
            with spans.read("ingest.has"):     # a scalar sent to the card
                st.has[u_dev] = True
            st.n_samples[u_dev] += out.counts
            st.energy_j[u_dev] += out.d_energy
            st.energy_corr_j[u_dev] += out.d_energy_corr
            st.win_j[u_dev] += out.d_win
            st.win_corr_j[u_dev] += out.d_win_corr
            st.run_t[u_dev] = out.new_run_t
            st.n_changes[u_dev] = out.new_n_changes
            st.n_out[u_dev] += out.n_out

            # drift EWMA over wall time, one slab-mean step per device
            mean_vc = out.sum_vc / out.counts
            alpha = torch.exp(-torch.clamp_min(out.new_t - old_last_t, 0.0)
                              / self.drift_tau_s)
            st.ewma_w[u_dev] = torch.where(
                had, alpha * st.ewma_w[u_dev] + (1.0 - alpha) * mean_vc,
                mean_vc)

            rec = out.run_rec
            with spans.read("ingest.runs", 2):
                rec_dev, rec_dur = dev[rec], out.run_dur[rec]
            self.periods.record(rec_dev, rec_dur)

        self._merge_label_moments(self._label_codes[u_dev], out.counts,
                                  out.sum_vc, out.sum_vc2, out.sum_abs_vc,
                                  out.max_abs_vc)
        if self.health is not None:
            with spans.span("ingest.health"):
                with spans.read("ingest.health"):
                    t_now = float(out.new_t.max())
                self._maybe_update_health(t_now)
        return IngestReport(k, n_dup, n_late, n_invalid, int(u_dev.numel()),
                            n_rej)

    def ingest_grid(self, dev, ts, vals) -> IngestReport:
        """Fold one rectangular slab: ``dev`` [D] distinct ascending
        device ids, ``ts`` [M] strictly increasing times shared by every
        device, ``vals`` [D, M] raw readings.

        The clean-stream fast path (no sorting, no per-sample scatter).
        Slabs that break the rectangular contract (unsorted ids or
        times, non-finite values, samples at or behind a device's newest
        accepted sample) fall back to :meth:`ingest` with identical
        semantics."""
        with spans.span("ingest.grid"):
            return self._ingest_grid(dev, ts, vals)

    def _ingest_grid(self, dev, ts, vals) -> IngestReport:
        d0 = self.device
        st = self.state
        with spans.span("ingest.prep"):
            dev = torch.as_tensor(dev, device=d0).to(I64).reshape(-1)
            ts = torch.as_tensor(ts, dtype=F64, device=d0).reshape(-1)
            vals = torch.as_tensor(vals, dtype=F64, device=d0)
            d, m = dev.numel(), ts.numel()
            if tuple(vals.shape) != (d, m):
                raise ValueError(f"vals must be [{d}, {m}], "
                                 f"got {tuple(vals.shape)}")
            if d == 0 or m == 0:
                return IngestReport(0, 0, 0, 0, 0)
            n_rej = 0
            ok_id = self._check_ids(dev)
            if ok_id is not None:
                with spans.read("ingest.ids", 3):
                    n_rej = int(ok_id.numel() - ok_id.sum()) * m
                    self._n_rejected += n_rej
                    dev, vals = dev[ok_id], vals[ok_id]
                self._count_drops(n_rej, 0, 0, 0)
                d = dev.numel()
                if d == 0:
                    self.epoch += 1     # counters mutated: publish fresh
                    return IngestReport(0, 0, 0, 0, 0, n_rej)

            clean = torch.stack([
                (torch.diff(dev) > 0).all(),
                (torch.diff(ts) > 0).all(),
                torch.isfinite(ts).all(),
                torch.isfinite(vals).all(),
                ~(st.has[dev] & (ts[0] <= st.last_t[dev])).any()]).all()
            with spans.read("ingest.clean"):
                if self.health is None:
                    clean = bool(clean)
                else:
                    # the health step's clock comes back in the same transfer
                    clean, t_last = torch.stack([clean.to(F64),
                                                 ts[-1]]).tolist()
                    clean = bool(clean)
        if not clean:
            spans.count("ingest.fallbacks")
            rep = self.ingest(torch.repeat_interleave(dev, m), ts.repeat(d),
                              vals.reshape(-1))
            return (dataclasses.replace(rep, rejected=rep.rejected + n_rej)
                    if n_rej else rep)
        with spans.span("ingest.prep"):
            self.epoch += 1
            c = self.corrections
            v = vals - c.baseline_w[dev][:, None]
            had = st.has[dev]
            run_t_in = torch.where(had, st.run_t[dev], ts[0])
        with spans.span("ingest.kernel"):
            out = stream_ingest_grid(
                ts, v, st.last_t[dev], st.last_v[dev], had, run_t_in,
                st.n_changes[dev], c.gain[dev], c.offset_w[dev],
                c.time_shift_s[dev], self._win_a[dev], self._win_b[dev],
                self._max_hold[dev], self._env_lo[dev], self._env_hi[dev],
                self.trapezoid)

        with spans.span("ingest.fold"):
            # ring snapshots see running totals *before* this slab is folded
            if self.ring.slots:
                self.ring.write_grid(
                    dev, ts, v, st.energy_j[dev][:, None] + out.cum_e,
                    st.energy_corr_j[dev][:, None] + out.cum_ec)
            else:
                self.ring.n_written[dev] += m

            old_last_t = st.last_t[dev]
            st.first_t[dev] = torch.where(had, st.first_t[dev], ts[0])
            st.last_t[dev] = ts[-1]
            st.last_v[dev] = out.new_v
            with spans.read("ingest.has"):     # a scalar sent to the card
                st.has[dev] = True
            st.n_samples[dev] += m
            st.energy_j[dev] += out.d_energy
            st.energy_corr_j[dev] += out.d_energy_corr
            st.win_j[dev] += out.d_win
            st.win_corr_j[dev] += out.d_win_corr
            st.run_t[dev] = out.new_run_t
            st.n_changes[dev] = out.new_n_changes
            st.n_out[dev] += out.n_out

            mean_vc = out.sum_vc / m
            alpha = torch.exp(-torch.clamp_min(ts[-1] - old_last_t, 0.0)
                              / self.drift_tau_s)
            st.ewma_w[dev] = torch.where(
                had, alpha * st.ewma_w[dev] + (1.0 - alpha) * mean_vc,
                mean_vc)

            rec = out.run_rec
            with spans.read("ingest.runs", 2):
                rec_dev = dev[:, None].expand(d, m)[rec]
                rec_dur = out.run_dur[rec]
            self.periods.record(rec_dev, rec_dur)

        self._merge_label_moments(self._label_codes[dev],
                                  torch.full_like(dev, m), out.sum_vc,
                                  out.sum_vc2, out.sum_abs_vc,
                                  out.max_abs_vc)
        if self.health is not None:
            with spans.span("ingest.health"):
                self._maybe_update_health(t_last)
        return IngestReport(d * m, 0, 0, 0, d, n_rej)

    def _merge_label_moments(self, codes, n, s1, s2, sa, mx):
        """Chan-merge one slab's corrected-reading moments per label.
        Each row (a device) has label ``codes``, ``n`` samples and the
        sums ``s1``/``s2``/``sa`` of vc, vc², |vc| and the max ``mx`` of
        |vc|.  The [labels] vectors come to the host once per slab."""
        with spans.span("ingest.moments"):
            nl = len(self._label_names)
            z = torch.zeros(nl, dtype=F64, device=codes.device)
            red = torch.stack([
                z.index_add(0, codes, n.to(F64)),
                z.index_add(0, codes, s1), z.index_add(0, codes, s2),
                z.index_add(0, codes, sa),
                z.scatter_reduce(0, codes, mx, "amax", include_self=True)])
            with spans.read("ingest.moments"):
                cnt, s1h, s2h, sah, mxh = red.cpu().numpy()
            for ci in np.flatnonzero(cnt):
                nb = int(cnt[ci])
                mean = s1h[ci] / nb
                m2 = max(float(s2h[ci] - nb * mean * mean), 0.0)
                self._moments.setdefault(
                    self._label_names[ci], StreamingMoments()).merge(
                        nb, float(mean), m2, float(sah[ci] / nb),
                        float(mxh[ci]))

    # -- health -----------------------------------------------------------
    def _count_drops(self, rejected: int, invalid: int, duplicates: int,
                     late: int) -> None:
        """Count the samples a slab's prep dropped (host ints it already
        holds: no read) under ``ingest.dropped.<reason>``."""
        for name, n in (("rejected", rejected), ("invalid", invalid),
                        ("duplicates", duplicates), ("late", late)):
            spans.count("ingest.dropped." + name, n)

    def _maybe_update_health(self, t_now: float) -> None:
        """Run the health machine at a slab boundary, at most once per
        ``health_every_s`` of stream time.  Time going backward across
        slabs (chunked replays restart the clock per device chunk) never
        triggers a step.  Whether anything changed is not read back: the
        slab already bumped the epoch."""
        if self.health is None or not np.isfinite(t_now):
            return
        if t_now < self._next_health_t:
            return
        self._next_health_t = t_now + self.health_every_s
        self._health_step(t_now)

    def _health_step(self, t_now: float) -> torch.Tensor:
        return self.health.update(
            self.state, t_now=float(t_now), policy=self.health_policy,
            period_est=self.periods.estimates(),
            ref_period_s=self.corrections.ref_period_s,
            silent_after_s=self.silent_after_s,
            drift_tau_s=self.drift_tau_s, drift_rel=self.drift_rel,
            drift_abs_w=self.drift_abs_w)

    def update_health(self, t_now: float) -> bool:
        """Evaluate one health step at wall-clock ``t_now`` (no-op without
        a policy).  Returns True when any device changed state (a read
        back from the device); a call that changes state bumps the epoch
        (ingestion's own slab-boundary steps ride the slab's bump)."""
        if self.health is None:
            return False
        changed = bool(self._health_step(t_now))
        if changed:
            self.epoch += 1
        return changed

    # -- accounting -------------------------------------------------------
    @property
    def counters(self) -> Dict[str, int]:
        st = self.state
        sums = [st.n_samples.sum(), st.n_dup.sum(), st.n_late.sum(),
                st.has.sum()]
        if self.health is not None:
            sums += self.health.count_tensors()
        vals = [int(x) for x in torch.stack(sums).tolist()]
        out = {
            "accepted": vals[0],
            "duplicates": vals[1],
            "late": vals[2],
            "invalid": self._n_invalid,
            "rejected": self._n_rejected,
            "devices_reporting": vals[3],
        }
        if self.health is not None:
            out.update(zip(("n_healthy", "n_stale", "n_quarantined"),
                           vals[4:]))
        return out
