"""K2's (``conv_threshold``) share of its roofline in the singlestream
cells."""

from tinybench.metrics._roofline import conv_threshold_roofline

UNIT = "%"


def read(ctx):
    return conv_threshold_roofline(ctx, "singlestream")
