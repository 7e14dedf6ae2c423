"""The card's idle time a slab under the ingest core's ``ingest.health``
phase: the idle gaps inside portbench's ``ingest`` spans at the instants
the program's innermost open phase was ``ingest.health`` (its ``read.*``
span included), on the trace's clock (``portbench.health_spans``), in
ms."""
from portbench import health_spans


def read(ctx):
    return health_spans.idle_ms(ctx)
