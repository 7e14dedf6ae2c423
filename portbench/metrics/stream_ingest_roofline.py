"""``stream_ingest``'s share of its roofline: the least time its bytes
and float64 operations allow (``portbench.counts.ingest``) over its mean
device time a launch in the trace, in %."""
from portbench.counts import peaks


def read(ctx):
    k = ctx.info.get("kernels", {}).get("stream_ingest")
    if k is None:
        return None
    times = ctx.trace.kernel_times(k["symbol"])
    if not times:
        return None
    return 100.0 * peaks.bound_s(k["bytes"], k["ops"]) / (
        sum(times) / len(times))
