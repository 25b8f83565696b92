"""Minimal MQTT 3.1.1 publisher — no external client library.

Counterpart of ``evam_tpu/publish/mqtt.py`` (a copy).

The reference publishes results through a mosquitto sidecar
(mosquitto/mosquitto.conf:1-2, destination type mqtt at
charts/templates/NOTES.txt:15-19). paho-mqtt is not in this image, so
this is a from-scratch QoS-0 publisher speaking the MQTT 3.1.1 wire
protocol (OASIS spec): CONNECT/CONNACK, PUBLISH, PINGREQ keepalive,
DISCONNECT. Reconnects with backoff on broken pipes — the publisher
thread must never take down the stream (the reference leaves a
"attempt reconnect?" TODO at evas/publisher.py:253-255; here it's
implemented).
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time

from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.publish.mqtt")


def _encode_remaining_length(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        if n:
            byte |= 0x80
        out.append(byte)
        if not n:
            return bytes(out)


def _utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


class MqttClient:
    """Blocking QoS-0 MQTT 3.1.1 client (publish-only)."""

    def __init__(
        self,
        host: str,
        port: int = 1883,
        client_id: str = "",
        keepalive: int = 60,
        timeout: float = 5.0,
    ):
        self.host = host
        self.port = port
        self.client_id = client_id or f"evam-tpu-{int(time.time()) & 0xFFFF}"
        self.keepalive = keepalive
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._last_send = 0.0

    # ------------------------------------------------------------ wire

    def connect(self) -> None:
        sock = socket.create_connection((self.host, self.port), self.timeout)
        sock.settimeout(self.timeout)
        var_header = (
            _utf8("MQTT")
            + bytes([0x04])          # protocol level 3.1.1
            + bytes([0x02])          # flags: clean session
            + struct.pack(">H", self.keepalive)
        )
        payload = _utf8(self.client_id)
        packet = (
            bytes([0x10])
            + _encode_remaining_length(len(var_header) + len(payload))
            + var_header
            + payload
        )
        sock.sendall(packet)
        ack = self._read_packet(sock)
        if not ack or ack[0] >> 4 != 2 or ack[-1] != 0:
            raise ConnectionError(f"CONNACK refused: {ack!r}")
        self._sock = sock
        self._last_send = time.monotonic()

    @staticmethod
    def _read_packet(sock: socket.socket) -> bytes:
        head = sock.recv(1)
        if not head:
            raise ConnectionError("broker closed connection")
        length = 0
        shift = 0
        while True:
            b = sock.recv(1)
            if not b:
                raise ConnectionError("short packet")
            length |= (b[0] & 0x7F) << shift
            if not b[0] & 0x80:
                break
            shift += 7
        body = b""
        while len(body) < length:
            chunk = sock.recv(length - len(body))
            if not chunk:
                raise ConnectionError("short packet body")
            body += chunk
        return head + body

    def publish(self, topic: str, payload: bytes) -> None:
        packet = (
            bytes([0x30])  # PUBLISH, QoS 0, no retain
            + _encode_remaining_length(2 + len(topic.encode()) + len(payload))
            + _utf8(topic)
            + payload
        )
        with self._lock:
            if self._sock is None:
                raise ConnectionError("not connected")
            self._sock.sendall(packet)
            self._last_send = time.monotonic()

    def ping_if_idle(self) -> None:
        with self._lock:
            if self._sock is None:
                return
            if time.monotonic() - self._last_send > self.keepalive / 2:
                self._sock.sendall(bytes([0xC0, 0x00]))  # PINGREQ
                self._last_send = time.monotonic()

    def disconnect(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.sendall(bytes([0xE0, 0x00]))
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


class MqttDestination:
    """Destination publishing metadata JSON (and optional frame blob on
    ``<topic>/frames``) with automatic reconnect."""

    #: thread-shared attributes and the lock that guards each (the
    #: ``locks`` pass of ``evam_tpu_torch.analysis`` checks them)
    SHARED_UNDER = {"_dropped": "_lock"}

    def __init__(
        self,
        host: str,
        port: int = 1883,
        topic: str = "evam_tpu",
        max_backoff: float = 10.0,
        lazy: bool = True,
    ):
        self.topic = topic
        self.max_backoff = max_backoff
        self._client = MqttClient(host, port)
        self._backoff = 0.5
        self._next_retry = 0.0
        self._lock = threading.Lock()
        #: guarded by ``_lock``: the publishing stream thread increments
        self._dropped = 0
        if not lazy:
            self._client.connect()

    def _ensure(self) -> bool:
        if self._client._sock is not None:
            return True
        if time.monotonic() < self._next_retry:
            return False
        try:
            self._client.connect()
            self._backoff = 0.5
            log.info("mqtt connected to %s:%d", self._client.host,
                     self._client.port)
            return True
        except OSError as exc:
            self._next_retry = time.monotonic() + self._backoff
            self._backoff = min(self._backoff * 2, self.max_backoff)
            log.warning("mqtt connect failed (%s); retry in %.1fs",
                        exc, self._backoff)
            return False

    def _drop(self) -> None:
        # shared drop accounting across destination kinds (mqtt/
        # file): one metric an operator can alert on for ANY sink
        with self._lock:
            self._dropped += 1
        metrics.inc("evam_publish_dropped", labels={"dest": "mqtt"})

    def publish(self, meta: dict, frame: bytes | None = None) -> None:
        if not self._ensure():
            self._drop()
            return
        payload = json.dumps(meta, separators=(",", ":")).encode()
        try:
            self._client.publish(self.topic, payload)
            if frame is not None:
                self._client.publish(self.topic + "/frames", frame)
            self._client.ping_if_idle()
        except OSError as exc:
            log.warning("mqtt publish failed (%s); reconnecting", exc)
            self._client.disconnect()
            self._drop()

    @property
    def dropped(self) -> int:
        return self._dropped

    def close(self) -> None:
        self._client.disconnect()
