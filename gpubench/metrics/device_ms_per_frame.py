"""device_ms_per_frame: kernel device milliseconds a resolved frame (``harness/readers.py`` ``device_ms_per_frame``)."""

from gpubench.harness.readers import device_ms_per_frame


def read(ctx):
    return device_ms_per_frame(ctx)
