"""The share of the samples sent in the traced stretch that the ingest
core's prep dropped: the program's counters
``ingest.dropped.{rejected,invalid,duplicates,late}`` over the samples
the driver sent (``sent_traced``), in %."""
from portbench import spans

REASONS = ("rejected", "invalid", "duplicates", "late")


def read(ctx):
    prog = spans.program(ctx, "ingest")
    sent = ctx.info.get("sent_traced")
    if prog is None or not sent:
        return None
    names = ["ingest.dropped." + r for r in REASONS]
    if not any(n in prog.counters for n in names):
        return None
    return 100.0 * sum(prog.count(n) for n in names) / sent
