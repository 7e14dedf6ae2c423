"""The ingest core's own time a slab: the mean of the program's top spans
``ingest.grid`` / ``ingest.flat`` (``repro_torch.common.spans``), the
inside counterpart of ``ingest_call_ms``, in ms."""
from portbench import spans


def read(ctx):
    prog = spans.program(ctx, "ingest")
    if prog is None:
        return None
    times = prog.top_ms()
    return sum(times) / len(times)
