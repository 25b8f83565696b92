"""engine_host_ms.sat: the engine's host milliseconds a batch, in a saturated cell (``harness/readers.py`` ``engine_host_ms``)."""

from gpubench.harness.readers import engine_host_ms


def read(ctx):
    return engine_host_ms(ctx)
