"""The whole ``offline()`` step's share of the int8 peak in the singlestream
cells: the measured window's inferences times the operations of one
(``counts.ops_per_inference``) over the window's seconds times 1,979e12."""

from tinybench.counts import PEAK_INT8_OPS

UNIT = "%"


def read(ctx):
    w = ctx.window
    if ctx.scenario != "singlestream" or not w.calls:
        return None
    return 100.0 * w.rows * ctx.ops_per_inference / (w.elapsed_s
                                                      * PEAK_INT8_OPS)
