"""Service settings and env interpolation (counterpart of ``evam_tpu/config``)."""

from evam_tpu_torch.config.interpolate import interpolate_env, interpolate_tree
from evam_tpu_torch.config.settings import Settings, get_settings, reset_settings

__all__ = [
    "Settings",
    "get_settings",
    "reset_settings",
    "interpolate_env",
    "interpolate_tree",
]
