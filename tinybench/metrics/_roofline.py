"""K2's share of its roofline over a traced window: the benchmark's bound
for the window's calls (``counts.conv_threshold_bound_s``) over K2's
device time; nothing where K2 did not run."""

from tinybench.counts import (CONV_THRESHOLD_KERNEL, conv_threshold_bound_s,
                              kernel_is)


def conv_threshold_roofline(ctx, scenario):
    t = ctx.trace
    if ctx.scenario != scenario or t is None or not t.calls:
        return None
    busy = sum(o.dur for o in t.ops if o.cat == "kernel"
               and kernel_is(o.name, CONV_THRESHOLD_KERNEL))
    if busy <= 0:
        return None
    bound = t.calls * conv_threshold_bound_s(ctx.graph, ctx.rows_per_call)
    return 100.0 * bound / busy
