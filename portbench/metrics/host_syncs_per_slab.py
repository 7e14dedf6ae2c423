"""Times the ingest core waits for the card a slab: synchronising runtime
calls (stream, device and event synchronisations, synchronous copies)
made inside portbench's ``ingest`` spans, over the number of spans."""


def read(ctx):
    n = len(ctx.trace.spans.get("ingest", []))
    return ctx.trace.runtime_in("ingest") / n if n else None
