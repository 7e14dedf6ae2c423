"""The calls that make the audit wait for the card, as the program counts
them (``audit.host_reads``: each ``read.*`` span's reads, the prefetch
worker's included), a million audited devices."""
from portbench import spans


def read(ctx):
    prog = spans.program(ctx, "audit")
    n = ctx.info.get("devices_traced")
    return None if prog is None or not n else (
        prog.count("audit.host_reads") / n * 1e6)
