"""List a dry-run cell's top dot sites by FLOPs on one rank (the port of
``tools/top_dots.py``, which reads them from the HLO's ``op_name``).

    PYTHONPATH=src python tools/torch_top_dots.py ARCH SHAPE
        [--mesh single|multi|tiny] [--reduced] [--json PATH]

The cell is traced on the CPU over placeholder ranks as
``python -m repro_torch.launch.dryrun`` traces it, with the counter's
sites on (``launch/opcount.py``): each dot is keyed by its aten op and
the innermost frame under ``repro_torch/models/``.  ``REPRO_DRYRUN_DEVICES``
is the rank count (256 by default: ``pod16x16``).  Prints ``TOTAL``, the
rank's dot FLOPs, then the top 18 sites with their share and count;
``--json`` writes the exact totals and every site.
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
    agg = {f"{op} | {site}": n for (op, site), n in
           counter.dot_sites.items()}
    cnt = {f"{op} | {site}": counter.site_calls[op, site]
           for op, site in counter.dot_sites}
    total = sum(agg.values())
    print(f"TOTAL {total:.3e} dot flops/device")
    for k, fl in sorted(agg.items(), key=lambda kv: -kv[1])[:18]:
        print(f"{fl:11.3e} ({fl/total*100:5.1f}%) x{cnt[k]:4d} {k}")
    if t["args"].json:
        with open(t["args"].json, "w") as f:
            json.dump({"dot_flops": counter.dot_flops, "total": total,
                       "sites": [{"site": k, "flops": v, "count": cnt[k]}
                                 for k, v in agg.items()]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
