"""device_idle: the share of the profiled stretch with the device idle (``harness/readers.py`` ``device_idle``)."""

from gpubench.harness.readers import device_idle


def read(ctx):
    return device_idle(ctx)
