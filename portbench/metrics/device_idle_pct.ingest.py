"""The card's idle share over the traced stretch: one minus the union of
its kernels, copies and sets (overlapping streams counted once) over the
stretch, in %."""


def read(ctx):
    return ctx.trace.idle_pct()
