"""The whole slab's share of the card's HBM roofline: the least bytes a
slab's ingest must move (its samples once, each per-device state field of
its devices read and written once; ``portbench.counts.ingest``) at the
peak bandwidth, over the window's wall time a slab outside the traced
stretch, in %."""
from portbench.counts import peaks


def read(ctx):
    need = ctx.info.get("min_bytes_per_unit")
    wall = ctx.info.get("wall_per_unit_s")
    if not need or not wall:
        return None
    return 100.0 * need / peaks.HBM_BYTES_PER_S / wall
