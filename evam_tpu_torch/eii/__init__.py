"""EII-mode service layer (counterpart of ``evam_tpu/eii``): a
headless service configured from a config store, one pipeline started
at boot, frames and metadata published over the brokerless message
bus, on the port's own ZeroMQ wire (``zmtp``)."""

from evam_tpu_torch.eii.configmgr import ConfigMgr
from evam_tpu_torch.eii.manager import EiiManager, run_eii_service
from evam_tpu_torch.eii.msgbus import MsgBusPublisher, MsgBusSubscriber

__all__ = [
    "ConfigMgr",
    "EiiManager",
    "MsgBusPublisher",
    "MsgBusSubscriber",
    "run_eii_service",
]
