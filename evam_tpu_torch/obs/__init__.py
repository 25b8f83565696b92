"""Logging and metrics (counterpart of ``evam_tpu/obs``; tracing,
fault injection and the flight recorder come with a later slice)."""

from evam_tpu_torch.obs.log import configure_logging
from evam_tpu_torch.obs.metrics import MetricsRegistry, metrics

__all__ = ["configure_logging", "MetricsRegistry", "metrics"]
