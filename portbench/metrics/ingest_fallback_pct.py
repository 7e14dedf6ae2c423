"""The share of grid slabs that broke the rectangular contract and went
the flat way (``ingest.fallbacks`` over the ``ingest.grid`` top spans),
in %."""
from portbench import spans


def read(ctx):
    prog = spans.program(ctx, "ingest")
    if prog is None:
        return None
    grid = sum(1 for _, top in prog.pairs if top.name == "ingest.grid")
    return 100.0 * prog.count("ingest.fallbacks") / grid if grid else None
