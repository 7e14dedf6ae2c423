"""Device-busy seconds (the union of the card's operations) a million
audited devices, over the traced stretch."""


def read(ctx):
    n = ctx.info.get("devices_traced")
    busy = ctx.trace.busy_s()
    return busy / n * 1e6 if n and busy > 0 else None
