"""``python -m repro_torch.collect``: replay recorded logs, manage
artifacts.

The counterpart of :mod:`repro.collect.cli`, with the same commands and
the same JSON keys.  The monitor runs on the card unless
``--torch-device cpu`` asks for the CPU (``--device`` is the
``calibrate`` commands' device uuid, as in the reference).  Two command
families:

``replay LOG``
    Parse a recorded nvidia-smi / daemon CSV log, resolve gpu_uuids
    through a :class:`~repro_torch.collect.registry.DeviceRegistry`, look up
    active calibration artifacts, and drive the full streaming monitor —
    printing a JSON summary (wire counters, registry growth, ingest
    counters, raw and corrected fleet energy).  This is the committed
    fixture's smoke path in CI and the quickstart's "ingest a real
    cluster log" entry point.

``calibrate list|save|activate|deactivate|gc``
    The :class:`~repro_torch.core.calibrate_store.ArtifactStore` lifecycle
    from the shell: inspect versions, save nominal records, roll the
    active version forward/back, and age out stale artifacts.

Everything prints JSON on stdout (one object), so the commands compose
with ``jq`` and the CI smoke test asserts on parsed output rather than
scraping text.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from repro_torch.collect import wire
from repro_torch.collect.assembler import CollectorPipeline
from repro_torch.collect.registry import DeviceRegistry
from repro_torch.core import profiles
from repro_torch.core.calibrate import CalibrationRecord, nominal_record
from repro_torch.core.calibrate_store import ArtifactStore, StoreError


def _default_record(profile_name: Optional[str],
                    gain: Optional[float] = None,
                    offset_w: Optional[float] = None,
                    device_id: str = "*",
                    note: str = "") -> Optional[CalibrationRecord]:
    if profile_name is None:
        return None
    rec = nominal_record(device_id, profiles.get(profile_name))
    if gain is not None or offset_w is not None or note:
        rec = dataclasses.replace(
            rec, gain=gain, offset_w=offset_w, note=note,
            source="repro_torch.collect.cli")
    return rec


# -- replay -------------------------------------------------------------------

def cmd_replay(args: argparse.Namespace) -> int:
    store = ArtifactStore(args.store) if args.store else None
    default = _default_record(args.default_profile)
    registry = DeviceRegistry(
        on_unknown="reject" if args.frozen else "add")
    if args.frozen:
        for dev in args.frozen:
            registry.add(dev)
    pipe = CollectorPipeline(
        store=store, default_record=default, registry=registry,
        device=args.torch_device, slab_samples=args.slab_samples,
        rebase=args.rebase, baseline_w=args.baseline_w,
        max_age_s=args.max_age_s, now=args.now,
        monitor_kwargs={"strict_ids": False})
    counters = wire.WireCounters()
    for batch in wire.iter_batches(args.log, fmt=args.format,
                                   batch_rows=args.batch_rows,
                                   counters=counters):
        pipe.feed(batch)
    monitor = pipe.finish()

    out = {
        "log": args.log,
        "wire": counters.as_dict(),
        "registry": registry.summary(),
        "pipeline": pipe.summary(),
    }
    if monitor is not None:
        from repro_torch.serve.monitor_service import (MonitorQuery,
                                                       MonitorQueryService)
        svc = MonitorQueryService(monitor)
        corrected, raw = svc.query_many([
            MonitorQuery.fleet_energy(corrected=True),
            MonitorQuery.fleet_energy(corrected=False),
        ])
        out["fleet_energy"] = {
            "corrected_j": corrected.total_j,
            "raw_j": raw.total_j,
            "n_reporting": corrected.n_reporting,
            "sigma_independent_j": corrected.sigma_independent_j,
            "sigma_worstcase_j": corrected.sigma_worstcase_j,
            "coverage": corrected.coverage,
        }
    _emit(out, args.json_path)
    return 0


# -- calibrate ----------------------------------------------------------------

def cmd_calibrate_list(args: argparse.Namespace) -> int:
    store = ArtifactStore(args.store)
    out = {"store": store.root,
           "artifacts": [info.summary() for info in store.list_all()]}
    _emit(out, args.json_path)
    return 0


def cmd_calibrate_save(args: argparse.Namespace) -> int:
    store = ArtifactStore(args.store)
    rec = _default_record(args.profile, gain=args.gain,
                          offset_w=args.offset_w, device_id=args.device,
                          note=args.note)
    assert rec is not None          # --profile is required by argparse
    v = store.save(rec, activate=args.activate)
    _emit({"device_id": args.device, "version": v,
           "active": bool(args.activate)}, args.json_path)
    return 0


def cmd_calibrate_activate(args: argparse.Namespace) -> int:
    store = ArtifactStore(args.store)
    store.activate(args.device, args.version)
    _emit({"device_id": args.device, "active_version": args.version},
          args.json_path)
    return 0


def cmd_calibrate_deactivate(args: argparse.Namespace) -> int:
    store = ArtifactStore(args.store)
    was = store.deactivate(args.device)
    _emit({"device_id": args.device, "was_active": was}, args.json_path)
    return 0


def cmd_calibrate_gc(args: argparse.Namespace) -> int:
    store = ArtifactStore(args.store)
    removed = store.gc(args.max_age_s, now=args.now,
                       keep_active=not args.collect_active,
                       dry_run=args.dry_run)
    _emit({"removed": removed, "dry_run": bool(args.dry_run)},
          args.json_path)
    return 0


# -- plumbing -----------------------------------------------------------------

def _emit(obj: dict, json_path: Optional[str]) -> None:
    text = json.dumps(obj, indent=2, sort_keys=True, default=_jsonify)
    if json_path:
        with open(json_path, "w") as f:
            f.write(text + "\n")
    print(text)


def _jsonify(x):
    import numpy as np
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"not JSON-serialisable: {type(x).__name__}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.collect",
        description="Replay recorded power logs into the streaming "
                    "monitor; manage versioned calibration artifacts.")
    sub = ap.add_subparsers(dest="command", required=True)

    rp = sub.add_parser("replay", help="replay a recorded CSV log "
                        "through the streaming monitor")
    rp.add_argument("log", help="path to the recorded log")
    rp.add_argument("--format", choices=("auto",) + wire.FORMATS,
                    default="auto", help="wire format (default: sniff)")
    rp.add_argument("--store", default=None,
                    help="ArtifactStore root for active calibrations")
    rp.add_argument("--default-profile", default=None,
                    help="nominal profile for devices without an active "
                         "artifact (e.g. a100); omit for identity")
    rp.add_argument("--torch-device", default="cuda",
                    choices=("cuda", "cpu"),
                    help="where the monitor runs (default: the card)")
    rp.add_argument("--slab-samples", type=int, default=65536)
    rp.add_argument("--batch-rows", type=int, default=8192)
    rp.add_argument("--rebase", action="store_true",
                    help="shift timestamps so the first sample is t=0")
    rp.add_argument("--baseline-w", type=float, default=0.0)
    rp.add_argument("--max-age-s", type=float, default=None,
                    help="ignore active artifacts older than this")
    rp.add_argument("--now", type=float, default=None,
                    help="reference instant for --max-age-s (epoch "
                         "seconds; default: wall clock)")
    rp.add_argument("--frozen", metavar="UUID", nargs="+", default=None,
                    help="freeze the fleet to these uuids: unknown "
                         "devices are rejected-and-counted, not added")
    rp.add_argument("--json", dest="json_path", default=None,
                    help="also write the summary JSON to this path")
    rp.set_defaults(func=cmd_replay)

    cal = sub.add_parser("calibrate",
                         help="versioned calibration artifact lifecycle")
    calsub = cal.add_subparsers(dest="subcommand", required=True)

    def _common(p, device=False):
        p.add_argument("--store", required=True,
                       help="ArtifactStore root directory")
        if device:
            p.add_argument("--device", required=True,
                           help="device id / gpu_uuid")
        p.add_argument("--json", dest="json_path", default=None)

    lp = calsub.add_parser("list", help="list every saved artifact")
    _common(lp)
    lp.set_defaults(func=cmd_calibrate_list)

    sp = calsub.add_parser("save", help="save a nominal record as a "
                           "new artifact version")
    _common(sp, device=True)
    sp.add_argument("--profile", required=True,
                    help=f"sensor profile ({', '.join(sorted(profiles.CATALOG))})")
    sp.add_argument("--gain", type=float, default=None)
    sp.add_argument("--offset-w", type=float, default=None)
    sp.add_argument("--note", default="")
    sp.add_argument("--activate", action="store_true")
    sp.set_defaults(func=cmd_calibrate_save)

    acp = calsub.add_parser("activate", help="activate a saved version")
    _common(acp, device=True)
    acp.add_argument("--version", type=int, required=True)
    acp.set_defaults(func=cmd_calibrate_activate)

    dep = calsub.add_parser("deactivate",
                            help="clear a device's active record")
    _common(dep, device=True)
    dep.set_defaults(func=cmd_calibrate_deactivate)

    gp = calsub.add_parser("gc", help="age out stale artifacts")
    _common(gp)
    gp.add_argument("--max-age-s", type=float, required=True)
    gp.add_argument("--now", type=float, default=None)
    gp.add_argument("--collect-active", action="store_true",
                    help="also collect active artifacts (default keeps "
                         "them)")
    gp.add_argument("--dry-run", action="store_true")
    gp.set_defaults(func=cmd_calibrate_gc)

    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except (StoreError, ValueError, FileNotFoundError, KeyError) as e:
        print(json.dumps({"error": str(e)}), file=sys.stderr)
        return 2
