"""The card's idle time a million audited devices under the audit's
``audit.moments`` phase: the idle gaps inside portbench's ``audit`` span at
the instants the program's innermost open phase was ``audit.moments`` (its
``read.*`` spans included), on the trace's clock (``portbench.spans``),
in s."""
from portbench import spans


def read(ctx):
    got = spans.phase_idle(ctx, "audit")
    n = ctx.info.get("devices_traced")
    return None if got is None or not n else (
        got[0]["audit.moments"] / n * 1e6)
