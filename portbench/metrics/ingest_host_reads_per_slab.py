"""The calls a slab that make the ingest core wait for the card, as the
program counts them (``ingest.host_reads``: each ``read.*`` span's
reads) over its slabs: the inside counterpart of ``host_syncs_per_slab``."""
from portbench import spans


def read(ctx):
    prog = spans.program(ctx, "ingest")
    return None if prog is None else (
        prog.count("ingest.host_reads") / prog.units)
