"""device: percent of the traced job's span in which no operation ran on
the device (1 - the union of the device's op intervals over the span)."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
