"""Attribute a dry-run cell's collective bytes on one rank to the ops
that caused them (the port of ``tools/attribute_collectives.py``, which
reads them from the HLO's ``op_name``).

    PYTHONPATH=src python tools/torch_attribute_collectives.py ARCH SHAPE
        [--mesh single|multi|tiny] [--reduced] [--json PATH]

The cell is traced on the CPU over placeholder ranks as
``python -m repro_torch.launch.dryrun`` traces it, with the counter's
sites on (``launch/opcount.py``): each collective is keyed by its kind,
its aten op and the innermost frame under ``repro_torch/models/``.
``REPRO_DRYRUN_DEVICES`` is the rank count (256 by default:
``pod16x16``).  Prints ``TOTAL``, the rank's collective GB, then the top
25 (kind, site) rows; ``--json`` writes the exact totals by kind and
every row.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch.dryrun import attributed_cell  # noqa: E402


def main(argv=None) -> int:
    t = attributed_cell(argv, __doc__.splitlines()[0])
    counter = t["counter"]
    agg = {(kind, f"{op} | {site}"): b for (kind, op, site), b in
           counter.collective_sites.items()}
    cnt = {(kind, f"{op} | {site}"): counter.site_calls[kind, op, site]
           for kind, op, site in counter.collective_sites}
    total = sum(agg.values())
    print(f"TOTAL {total/1e9:.2f} GB/device")
    for (kind, opn), b in sorted(agg.items(), key=lambda kv: -kv[1])[:25]:
        print(f"{b/1e9:9.3f} GB  x{cnt[(kind, opn)]:3d} {kind:18s} {opn}")
    if t["args"].json:
        with open(t["args"].json, "w") as f:
            json.dump({"bytes_by_kind": counter.collectives.bytes_by_kind,
                       "total": total,
                       "rows": [{"kind": k, "site": s, "bytes": v,
                                 "count": cnt[k, s]}
                                for (k, s), v in agg.items()]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
