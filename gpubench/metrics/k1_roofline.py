"""k1_roofline: K1's share of its roofline (``harness/readers.py`` ``k1_roofline``)."""

from gpubench.harness.readers import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
