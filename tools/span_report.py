"""Where a traced run of one of portbench's cells spends its host time
and where it waits for the card, by the program's own spans
(``repro_torch.common.spans``).

    python3 tools/span_report.py <workload> [--seed N] [--seconds S] \
        [--waits]

Runs ``python3 -m portbench.run --workload <workload> --trace 1`` in this
process and prints its result line, then for each phase of the layer
(``ingest`` or ``audit``) the host ms a unit (a slab, an audit) and the
card's idle ms a unit inside portbench's spans, the idle outside every
phase, the phases' share of that idle and the clock residual.  With
``--waits`` PyTorch's sync debug mode warns on every call that makes the
host wait for the card while the program records; each is listed by its
source line and the program span open around it (``UNREAD`` when that is
not a ``read.*`` span), beside the program's own read counters.  The
warnings cost host time, so take the phase times from a run without
``--waits``.  Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _where() -> str:
    """The innermost line of the program on the current stack."""
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename]
    if not frames:
        return ""
    f = frames[-1]
    return f"{f.filename.split('src/')[-1]}:{f.lineno}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload")
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--waits", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness, run
    from portbench import spans as pspans
    from portbench.trace import TraceData
    from repro_torch.common import spans

    if not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 1
    waits = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message) or not spans.recording():
            return
        where = _where()
        if where:
            waits[(spans.current() or "no span", where)] += 1

    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        if args.waits:
            stack.enter_context(warnings.catch_warnings())
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, 0)
        stack.enter_context(contextlib.redirect_stdout(buf))
        rc = run.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"])
    if rc != 0:
        return rc
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(json.dumps(line))

    cell = harness.find_cell(harness.benchmark(ROOT), args.workload,
                             seed=args.seed, seconds=args.seconds,
                             trace=True)
    layer = "audit" if cell.config["system"] == "audit" else "ingest"
    trace = TraceData.load(harness.trace_path(cell))
    prog = pspans.program(harness.TraceContext(trace, {}), layer,
                          limit_us=float("inf"))
    if prog is not None and prog.residual_us > pspans.MAX_RESIDUAL_US:
        print(f"span_report: residual {prog.residual_us:.1f} us over "
              f"{pspans.MAX_RESIDUAL_US:g}: the metrics read None",
              file=sys.stderr)
    if prog is None:
        rec = spans.recorded()
        tops = [s for s in rec.spans
                if s.parent is None and s.name in pspans.TOPS[layer]]
        print(f"span_report: the program's spans do not align with the "
              f"trace: {len(trace.spans.get(layer, []))} portbench spans, "
              f"{len(tops)} top spans, {rec.dropped} dropped",
              file=sys.stderr)
        return 1
    idle = prog.idle_by_phase(trace.busy())
    tops = {top.id for _, top in prog.pairs}
    host = collections.Counter()
    for s in prog.spans:
        if s.root in tops and s.name in pspans.PHASES[layer]:
            host[s.name] += (s.t1_ns - s.t0_ns) * 1e-6
    u = prog.units
    print(f"{layer}: {u} units, residual {prog.residual_us:.1f} us, "
          f"top span {sum(prog.top_ms()) / u:.3f} ms a unit")
    print(f"{'phase':<18}{'host ms/unit':>14}{'idle ms/unit':>14}")
    for name in pspans.PHASES[layer] + ("other",):
        print(f"{name:<18}{host.get(name, 0.0) / u:>14.4f}"
              f"{1e3 * idle[name] / u:>14.4f}")
    covered = idle["total"] - idle["other"]
    print(f"idle inside portbench's spans {1e3 * idle['total'] / u:.4f} ms "
          f"a unit, {100 * covered / max(idle['total'], 1e-12):.2f}% "
          f"under a phase")
    print("counters: " + ", ".join(f"{k} {v} ({v / u:g} a unit)"
                                   for k, v in sorted(prog.counters.items())))
    if args.waits:
        print(f"waits while recording: {sum(waits.values())} "
              f"({sum(waits.values()) / u:g} a unit)")
        for (name, where), n in sorted(waits.items(),
                                       key=lambda kv: -kv[1]):
            mark = "" if name.startswith("read.") else "  UNREAD"
            print(f"  {n / u:9.2f}  {where:<48} {name}{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
