"""The ingest core's host time a slab: the mean of portbench's ``ingest``
spans around ``MonitorService.ingest_grid`` / ``ingest``, in ms."""


def read(ctx):
    times = ctx.trace.span_times("ingest")
    return 1e3 * sum(times) / len(times) if times else None
