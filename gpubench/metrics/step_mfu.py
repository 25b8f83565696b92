"""step_mfu: the whole step's share of the card's published peak (``harness/readers.py`` ``step_mfu``)."""

from gpubench.harness.readers import step_mfu


def read(ctx):
    return step_mfu(ctx)
