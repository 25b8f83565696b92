"""Result destinations — the gvametapublish counterpart (counterpart
of ``evam_tpu/publish``: file, stdout, mqtt, zmq and null, the frame
encoding, the RTSP re-stream in ``publish/rtsp.py`` and the WebRTC
egress in ``publish/webrtc.py`` over ``publish/rtc/``)."""

from evam_tpu_torch.publish.base import Destination, create_destination
from evam_tpu_torch.publish.encode import encode_frame
from evam_tpu_torch.publish.file_dest import FileDestination, StdoutDestination
from evam_tpu_torch.publish.mqtt import MqttDestination
from evam_tpu_torch.publish.zmq_dest import ZmqDestination

__all__ = [
    "Destination",
    "FileDestination",
    "MqttDestination",
    "StdoutDestination",
    "ZmqDestination",
    "create_destination",
    "encode_frame",
]
