"""Logging, metrics, tracing and the flight recorder (``obs/trace.py``),
and fault injection (``obs/faults.py``): the counterpart of
``evam_tpu/obs``."""

from evam_tpu_torch.obs.log import configure_logging
from evam_tpu_torch.obs.metrics import MetricsRegistry, metrics

__all__ = ["configure_logging", "MetricsRegistry", "metrics"]
