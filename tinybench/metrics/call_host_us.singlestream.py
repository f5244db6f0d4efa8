"""Host time of one ``offline()`` call at batch 1, from its sending to its
return (the input's copy-in, the graph's replay launch, the output's
clone), by the benchmark's host clock: the mean over every call of the
measured window, which the trace does not slow."""

UNIT = "us"


def read(ctx):
    if ctx.scenario != "singlestream" or not ctx.window.calls:
        return None
    w = ctx.window
    return sum(r - i for i, r in zip(w.sent_ns, w.return_ns)) \
        / w.calls / 1e3
