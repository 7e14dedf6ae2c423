"""The card's idle time a slab under the ingest core's ``ingest.fold``
phase: the idle gaps inside portbench's ``ingest`` spans at the instants
the program's innermost open phase was ``ingest.fold`` (its ``read.*``
spans included), on the trace's clock (``portbench.spans``), in ms."""
from portbench import spans


def read(ctx):
    got = spans.phase_idle(ctx, "ingest")
    return None if got is None else 1e3 * got[0]["ingest.fold"] / got[1]
