"""Wire-format parsing: real power-telemetry logs → sample batches.

The counterpart of :mod:`repro.collect.wire`, host text in numpy (a
parse's accounting, its samples and its timestamps are the reference's).
Two formats cover what fleets actually emit:

* **smi** — ``nvidia-smi --query-gpu=... --format=csv`` output: a
  header row naming the columns (units in brackets, ``power.draw [W]``),
  then one row per GPU per poll.  Cells may be ``[N/A]``,
  ``[Unknown Error]`` or ``ERR!`` (the tool reports sensor failures
  in-band); power carries a unit suffix (``68.84 W``, ``68840 mW``) or
  none under ``--format=csv,nounits``; timestamps are
  ``YYYY/MM/DD HH:MM:SS.mmm`` (parsed as UTC — nvidia-smi prints local
  naive time, so collectors that care must run under ``TZ=UTC``; a
  deterministic parse beats a machine-dependent one).  Long captures
  (``-l``/``-lms`` loops, restarted collectors) repeat the header
  mid-stream; repeated headers re-bind the column order.
* **daemon** — per-row CSV from a polling daemon
  (``gpu_uuid,timestamp,power.draw,utilization``): epoch-seconds
  timestamps, unit-less floats, optional header.  This is the
  jacquetpi/daemon-ai-reader production shape.

Parsing never throws on bad data: malformed rows, ``[N/A]`` power
cells and error cells are dropped and **counted** in
:class:`WireCounters` — a collector that dies on one garbled line loses
the whole capture.  Rows survive in file order (duplicates and
out-of-order timestamps included): ordering policy belongs to the
monitor's ingest layer, which already drops-and-counts them, not to the
parser.

The writers (:func:`format_daemon`, :func:`format_query_gpu`) emit the
same formats — they feed the committed test fixture and the round-trip
property tests, and let a :class:`~repro_torch.collect.sampler.Sampler` dump a
live capture to disk in a replayable form.
"""
from __future__ import annotations

import dataclasses
from datetime import datetime, timezone
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

FORMATS = ("smi", "daemon")

# normalised header aliases -> canonical column names
_COLUMN_ALIASES = {
    "uuid": "uuid", "gpu_uuid": "uuid", "gpu uuid": "uuid",
    "timestamp": "timestamp",
    "power.draw": "power", "power.draw.instant": "power",
    "power.draw.average": "power", "power": "power",
    "utilization.gpu": "util", "utilization": "util",
}
_UNIT_SCALE = {"w": 1.0, "mw": 1e-3, "kw": 1e3}
_NA_CELLS = {"[n/a]", "n/a", "na"}
_ERR_CELLS = {"[unknown error]", "err!", "[unsupported]"}
_SMI_TS = "%Y/%m/%d %H:%M:%S"


@dataclasses.dataclass
class WireCounters:
    """Per-parse accounting: every input row lands in exactly one
    bucket (``samples + malformed + not_available + error_cells``
    plus ``headers``/``blank`` covers ``rows``)."""

    rows: int = 0             # physical non-empty lines seen
    samples: int = 0          # rows that produced a sample
    headers: int = 0          # header lines (incl. mid-stream repeats)
    blank: int = 0            # empty/whitespace lines
    malformed: int = 0        # wrong arity / unparseable cells
    not_available: int = 0    # power cell was [N/A]
    error_cells: int = 0      # power cell was [Unknown Error] / ERR!

    def merge(self, other: "WireCounters") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SampleBatch:
    """One parsed batch of raw power samples, columnar.

    ``uuid`` [K] device uuids (object), ``t`` [K] seconds (epoch or
    collector-relative — the parser preserves whatever the wire said),
    ``power_w`` [K] watts, ``util`` [K] utilisation percent (NaN when
    the wire had none).
    """

    uuid: np.ndarray
    t: np.ndarray
    power_w: np.ndarray
    util: np.ndarray

    def __len__(self) -> int:
        return self.t.shape[0]

    @classmethod
    def empty(cls) -> "SampleBatch":
        return cls(uuid=np.empty(0, dtype=object), t=np.empty(0),
                   power_w=np.empty(0), util=np.empty(0))

    @classmethod
    def from_rows(cls, uuids: Sequence[str], t: Sequence[float],
                  power_w: Sequence[float],
                  util: Optional[Sequence[float]] = None) -> "SampleBatch":
        k = len(t)
        return cls(uuid=np.asarray(list(uuids), dtype=object),
                   t=np.asarray(t, dtype=np.float64),
                   power_w=np.asarray(power_w, dtype=np.float64),
                   util=(np.full(k, np.nan) if util is None
                         else np.asarray(util, dtype=np.float64)))

    def concat(self, other: "SampleBatch") -> "SampleBatch":
        return SampleBatch(
            uuid=np.concatenate([self.uuid, other.uuid]),
            t=np.concatenate([self.t, other.t]),
            power_w=np.concatenate([self.power_w, other.power_w]),
            util=np.concatenate([self.util, other.util]))


# -- cell parsers -----------------------------------------------------------

def parse_power_cell(cell: str) -> Tuple[float, str]:
    """One power cell → ``(watts, status)`` with status one of
    ``"ok"``/``"na"``/``"error"``/``"malformed"`` (watts is NaN for
    everything but ``"ok"``).  Handles unit suffixes (``W``/``mW``/
    ``kW``), ``nounits`` bare floats, and the in-band failure cells."""
    s = cell.strip()
    low = s.lower()
    if low in _NA_CELLS:
        return np.nan, "na"
    if low in _ERR_CELLS:
        return np.nan, "error"
    parts = s.split()
    try:
        if len(parts) == 1:
            return float(parts[0]), "ok"
        if len(parts) == 2:
            scale = _UNIT_SCALE.get(parts[1].lower())
            if scale is None:
                return np.nan, "malformed"
            return float(parts[0]) * scale, "ok"
    except ValueError:
        pass
    return np.nan, "malformed"


def parse_timestamp_cell(cell: str) -> float:
    """One timestamp cell → epoch seconds (NaN when unparseable).

    Accepts bare epoch floats (daemon logs), nvidia-smi's
    ``YYYY/MM/DD HH:MM:SS.mmm`` and ISO-8601 ``YYYY-MM-DDTHH:MM:SS[.f]``
    — naive stamps are taken as UTC so a log parses to the same numbers
    on every machine."""
    s = cell.strip()
    try:
        return float(s)
    except ValueError:
        pass
    base, frac = s, 0.0
    if "." in s:
        base, frac_s = s.rsplit(".", 1)
        try:
            frac = float("0." + frac_s)
        except ValueError:
            return np.nan
    for fmt in (_SMI_TS, "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S"):
        try:
            dt = datetime.strptime(base, fmt)
        except ValueError:
            continue
        return dt.replace(tzinfo=timezone.utc).timestamp() + frac
    return np.nan


def parse_util_cell(cell: str) -> float:
    s = cell.strip().rstrip("%").strip()
    if s.lower() in _NA_CELLS or s.lower() in _ERR_CELLS or not s:
        return np.nan
    try:
        return float(s)
    except ValueError:
        return np.nan


def _header_map(cells: List[str]) -> Optional[dict]:
    """Map a header row to column positions, or None if it isn't one.
    A header binds a column for every alias it names; unknown columns
    (memory.used, temperature, ...) are simply ignored."""
    hit = {}
    for i, c in enumerate(cells):
        name = c.strip().lower()
        if "[" in name:                      # strip a " [W]" unit suffix
            name = name.split("[", 1)[0].strip()
        canon = _COLUMN_ALIASES.get(name)
        if canon is not None and canon not in hit:
            hit[canon] = i
    if "uuid" in hit and "power" in hit:
        return hit
    return None


# -- line-stream parsers ----------------------------------------------------

def _parse_lines(lines: Iterable[str], fmt: str,
                 strict_arity: bool = True
                 ) -> Tuple[SampleBatch, WireCounters]:
    """The shared row loop.  ``fmt`` picks the default column binding;
    header rows (either format) rebind columns mid-stream."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown wire format '{fmt}'; "
                         f"known: {', '.join(FORMATS)}")
    # daemon default binding applies before any header is seen; smi
    # requires its header (column order is whatever --query-gpu said)
    cols = ({"uuid": 0, "timestamp": 1, "power": 2, "util": 3}
            if fmt == "daemon" else None)
    n_cols = 4 if fmt == "daemon" else None
    c = WireCounters()
    uuids: List[str] = []
    ts: List[float] = []
    pw: List[float] = []
    ut: List[float] = []
    for line in lines:
        s = line.strip()
        if not s:
            c.blank += 1
            continue
        c.rows += 1
        cells = s.split(",")
        hdr = _header_map(cells)
        if hdr is not None and any(not _is_number(cells[i])
                                   for i in hdr.values()):
            cols = hdr
            n_cols = len(cells)
            c.headers += 1
            continue
        if cols is None:           # smi data before any header: no
            c.malformed += 1       # column binding to parse it with
            continue
        if len(cells) <= max(cols.values()) or (
                strict_arity and n_cols is not None
                and len(cells) != n_cols):
            c.malformed += 1
            continue
        t = parse_timestamp_cell(cells[cols["timestamp"]]) \
            if "timestamp" in cols else np.nan
        if not np.isfinite(t):
            c.malformed += 1
            continue
        p, status = parse_power_cell(cells[cols["power"]])
        if status == "na":
            c.not_available += 1
            continue
        if status == "error":
            c.error_cells += 1
            continue
        if status == "malformed":
            c.malformed += 1
            continue
        uuid = cells[cols["uuid"]].strip()
        if not uuid:
            c.malformed += 1
            continue
        u = (parse_util_cell(cells[cols["util"]])
             if "util" in cols and cols["util"] < len(cells) else np.nan)
        uuids.append(uuid)
        ts.append(t)
        pw.append(p)
        ut.append(u)
        c.samples += 1
    return SampleBatch.from_rows(uuids, ts, pw, ut), c


def _is_number(cell: str) -> bool:
    try:
        float(cell.strip())
        return True
    except ValueError:
        return False


def parse_query_gpu(text: Union[str, Iterable[str]]
                    ) -> Tuple[SampleBatch, WireCounters]:
    """Parse ``nvidia-smi --query-gpu ... --format=csv`` output."""
    lines = text.splitlines() if isinstance(text, str) else text
    return _parse_lines(lines, "smi")


def parse_daemon(text: Union[str, Iterable[str]]
                 ) -> Tuple[SampleBatch, WireCounters]:
    """Parse daemon-style per-row CSV
    (``gpu_uuid,timestamp,power.draw,utilization``; header optional)."""
    lines = text.splitlines() if isinstance(text, str) else text
    return _parse_lines(lines, "daemon")


def sniff_format(first_lines: Sequence[str]) -> str:
    """Guess the wire format from the first few non-empty lines.

    A header with bracketed units (or any nvidia-smi date-shaped
    timestamp cell) means **smi**; a 4-column row whose second cell is
    a bare float (epoch seconds) means **daemon**.  Falls back to
    daemon — the format with a default binding."""
    for line in first_lines:
        s = line.strip()
        if not s:
            continue
        if "[" in s and "]" in s and _header_map(s.split(",")):
            return "smi"
        cells = s.split(",")
        hdr = _header_map(cells)
        if hdr is not None and any(not _is_number(cells[i])
                                   for i in hdr.values()):
            # unit-less header: daemon's own header names its columns
            return "daemon" if "[" not in s else "smi"
        if len(cells) >= 2:
            if _is_number(cells[1]):
                return "daemon"
            if np.isfinite(parse_timestamp_cell(cells[1])):
                return "smi"
    return "daemon"


def iter_batches(path: str, fmt: str = "auto",
                 batch_rows: int = 8192,
                 counters: Optional[WireCounters] = None
                 ) -> Iterator[SampleBatch]:
    """Stream a log file as :class:`SampleBatch` chunks of about
    ``batch_rows`` rows — bounded memory however long the capture.
    Pass a :class:`WireCounters` to accumulate parse accounting across
    the whole file (each yielded batch folds into it)."""
    if batch_rows < 1:
        raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
    with open(path) as f:
        if fmt == "auto":
            head = []
            for line in f:
                head.append(line)
                if len(head) >= 8:
                    break
            fmt = sniff_format(head)
            f.seek(0)
        if fmt not in FORMATS:
            raise ValueError(f"unknown wire format '{fmt}'")
        # smi headers must survive chunk boundaries: parse chunk-wise but
        # re-feed the last seen header so column bindings persist
        pend: List[str] = []
        carry_header: List[str] = []
        for line in f:
            pend.append(line)
            if len(pend) >= batch_rows:
                batch, c = _parse_lines(carry_header + pend, fmt)
                if carry_header:
                    c.headers -= len(carry_header)
                    c.rows -= len(carry_header)
                carry_header = _last_header(pend, carry_header)
                if counters is not None:
                    counters.merge(c)
                pend = []
                if len(batch):
                    yield batch
        if pend:
            batch, c = _parse_lines(carry_header + pend, fmt)
            if carry_header:
                c.headers -= len(carry_header)
                c.rows -= len(carry_header)
            if counters is not None:
                counters.merge(c)
            if len(batch):
                yield batch


def _last_header(lines: List[str], prev: List[str]) -> List[str]:
    """The most recent header line in ``lines`` (falling back to the
    carried one) — what the next chunk parses under."""
    for line in reversed(lines):
        cells = line.strip().split(",")
        hdr = _header_map(cells)
        if hdr is not None and any(not _is_number(cells[i])
                                   for i in hdr.values()):
            return [line if line.endswith("\n") else line + "\n"]
    return prev


def parse_log(path: str, fmt: str = "auto"
              ) -> Tuple[SampleBatch, WireCounters]:
    """Parse a whole log file in one go (see :func:`iter_batches` for
    the bounded-memory streaming form).  Returns the samples plus the
    full parse accounting."""
    c = WireCounters()
    batches = list(iter_batches(path, fmt=fmt, counters=c))
    if not batches:
        return SampleBatch.empty(), c
    out = batches[0]
    for b in batches[1:]:
        out = out.concat(b)
    return out, c


# -- writers ----------------------------------------------------------------

def format_daemon(batch: SampleBatch, header: bool = True,
                  precision: Optional[int] = None) -> str:
    """Render a batch as daemon-style per-row CSV.  ``precision=None``
    writes ``repr`` floats (lossless round-trip — what the fixture's
    bitwise tests rely on); an int mimics a daemon that rounds."""
    def num(x: float) -> str:
        if not np.isfinite(x):
            return "nan"
        return repr(float(x)) if precision is None \
            else f"{float(x):.{precision}f}"

    lines = ["gpu_uuid,timestamp,power.draw,utilization"] if header else []
    for i in range(len(batch)):
        lines.append(f"{batch.uuid[i]},{num(batch.t[i])},"
                     f"{num(batch.power_w[i])},{num(batch.util[i])}")
    return "\n".join(lines) + "\n"


def format_query_gpu(batch: SampleBatch, nounits: bool = False,
                     power_decimals: int = 2) -> str:
    """Render a batch as ``nvidia-smi --query-gpu`` CSV (the lossy
    production format: millisecond timestamps, 2-decimal watts)."""
    unit_hdr = "power.draw, utilization.gpu" if nounits else \
        "power.draw [W], utilization.gpu [%]"
    lines = [f"uuid, timestamp, {unit_hdr}"]
    for i in range(len(batch)):
        dt = datetime.fromtimestamp(float(batch.t[i]), tz=timezone.utc)
        stamp = dt.strftime(_SMI_TS) + f".{dt.microsecond // 1000:03d}"
        p = f"{float(batch.power_w[i]):.{power_decimals}f}"
        u = ("[N/A]" if not np.isfinite(batch.util[i])
             else f"{float(batch.util[i]):.0f}")
        if nounits:
            lines.append(f"{batch.uuid[i]}, {stamp}, {p}, {u}")
        else:
            u = u if u == "[N/A]" else u + " %"
            lines.append(f"{batch.uuid[i]}, {stamp}, {p} W, {u}")
    return "\n".join(lines) + "\n"
