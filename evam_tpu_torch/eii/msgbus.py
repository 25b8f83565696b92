"""Message bus: brokerless ZeroMQ pub/sub with EII-style interface
configs.

Counterpart of ``evam_tpu/eii/msgbus.py``, on the port's own ZeroMQ
wire (``eii/zmtp.py``) in place of pyzmq, which the card's machine
lacks; it interoperates with pyzmq's sockets both ways. The same
interface-config dialect:

    {"Type": "zmq_tcp", "EndPoint": "0.0.0.0:65114",
     "Topics": ["camera1_stream_results"], "AllowedClients": ["*"],
     "zmq_recv_hwm": 50}

``zmq_tcp`` (EndPoint host:port) or ``zmq_ipc`` (EndPoint a socket
directory, ``EVAM_SOCKET_DIR`` by default; the socket is
``<dir>/<topic>``), ``zmq_send_hwm`` and ``zmq_recv_hwm`` (1000).
Wire framing: multipart [topic, meta-json, blob?] — topic first so the
publisher filters by subscription prefix. ``AllowedClients`` is
recorded, not enforced: dev mode (no CURVE), as in the reference.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any

from evam_tpu_torch.eii.zmtp import PubSocket, SubSocket

log = logging.getLogger("evam_tpu_torch.eii.msgbus")

SOCKET_DIR = os.environ.get("EVAM_SOCKET_DIR", "/tmp/evam_sockets")


def _endpoint(cfg: dict[str, Any], topic: str, bind: bool) -> str:
    btype = cfg.get("Type", "zmq_tcp")
    if btype == "zmq_tcp":
        host_port = cfg.get("EndPoint", "127.0.0.1:65114")
        if bind:
            return f"tcp://{host_port}"
        host, _, port = str(host_port).partition(":")
        host = "127.0.0.1" if host in ("0.0.0.0", "") else host
        return f"tcp://{host}:{port}"
    if btype == "zmq_ipc":
        sock_dir = cfg.get("EndPoint", SOCKET_DIR)
        os.makedirs(sock_dir, exist_ok=True)
        return f"ipc://{sock_dir}/{topic}"
    raise ValueError(f"unsupported msgbus type '{btype}'")


class MsgBusPublisher:
    """Publish ``(meta, blob)`` on one topic: a meta dict, or a meta
    dict and the frame's bytes."""

    def __init__(self, cfg: dict[str, Any], topic: str):
        self.topic = topic
        self._sock = PubSocket(hwm=int(cfg.get("zmq_send_hwm", 1000)))
        ep = _endpoint(cfg, topic, bind=True)
        try:
            self.endpoint = self._sock.bind(ep)
        except BaseException:
            self._sock.close()
            raise
        self.allowed_clients = list(cfg.get("AllowedClients", ["*"]))
        log.info("msgbus publisher topic=%s endpoint=%s", topic,
                 self.endpoint)

    def publish(self, meta: dict, blob: bytes | None = None) -> None:
        parts = [
            self.topic.encode(),
            json.dumps(meta, separators=(",", ":")).encode(),
        ]
        if blob is not None:
            parts.append(blob)
        # a slow consumer costs drops at its high-water mark, never a
        # stall of the pipeline
        self._sock.send_multipart(parts)

    def close(self) -> None:
        self._sock.close()


class MsgBusSubscriber:
    """``recv() -> (meta, blob|None)`` on one topic, ``None`` after
    ``recv_timeout_ms`` without a message (callers poll a stop flag)."""

    def __init__(self, cfg: dict[str, Any], topic: str,
                 recv_timeout_ms: int = 1000):
        self.topic = topic
        self._sock = SubSocket(hwm=int(cfg.get("zmq_recv_hwm", 1000)),
                               rcvtimeo_ms=recv_timeout_ms)
        self._sock.subscribe(topic.encode())
        ep = _endpoint(cfg, topic, bind=False)
        try:
            self._sock.connect(ep)
        except BaseException:
            self._sock.close()
            raise
        log.info("msgbus subscriber topic=%s endpoint=%s", topic, ep)

    def recv(self) -> tuple[dict, bytes | None] | None:
        parts = self._sock.recv_multipart()
        if parts is None:
            return None
        meta = json.loads(parts[1]) if len(parts) > 1 else {}
        blob = parts[2] if len(parts) > 2 else None
        return meta, blob

    def close(self) -> None:
        self._sock.close()
