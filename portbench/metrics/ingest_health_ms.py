"""The hardened monitor's health step, host ms a slab: the program's
``ingest.health`` phase spans (its read of the fleet's newest time
included) over the traced slabs (``portbench.health_spans``)."""
from portbench import health_spans


def read(ctx):
    return health_spans.host_ms(ctx)
