"""Result destinations — the gvametapublish counterpart (counterpart
of ``evam_tpu/publish``: file, stdout, mqtt and null; zmq and the
frame destinations come with a later slice)."""

from evam_tpu_torch.publish.base import Destination, create_destination
from evam_tpu_torch.publish.file_dest import FileDestination, StdoutDestination
from evam_tpu_torch.publish.mqtt import MqttDestination

__all__ = [
    "Destination",
    "FileDestination",
    "MqttDestination",
    "StdoutDestination",
    "create_destination",
]
