"""Share of the traced window's device time (every operation's time
summed) spent in host-to-device copies: the input's copy into the
graph's buffer."""

UNIT = "%"


def read(ctx):
    t = ctx.trace
    if ctx.scenario != "offline" or t is None or t.op_s <= 0:
        return None
    h2d = sum(o.dur for o in t.ops
              if o.cat == "gpu_memcpy" and "HtoD" in o.name)
    return 100.0 * h2d / t.op_s
