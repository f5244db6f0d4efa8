"""Share of the traced window's device time (every operation's time
summed) in kernels that are not the table's (K1, K2, K3, the float head):
pools, the flatten, int32 casts, the output's clone."""

from tinybench.counts import TABLE_KERNELS, kernel_is

UNIT = "%"


def read(ctx):
    t = ctx.trace
    if ctx.scenario != "offline" or t is None or t.op_s <= 0:
        return None
    other = sum(o.dur for o in t.ops if o.cat == "kernel" and not any(
        kernel_is(o.name, k) for k in TABLE_KERNELS))
    return 100.0 * other / t.op_s
