"""Share of the traced window in which no kernel or copy ran on the
device (the operations' intervals merged), in the offline cells."""

UNIT = "%"


def read(ctx):
    t = ctx.trace
    if ctx.scenario != "offline" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
