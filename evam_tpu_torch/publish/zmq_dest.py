"""ZeroMQ PUB destination with the EII MsgBus wire contract.

Counterpart of ``evam_tpu/publish/zmq_dest.py``, on the port's own
ZeroMQ wire (``eii/zmtp.py``) in place of pyzmq. The EII data plane is
brokerless pub/sub carrying ``(json-meta, frame-blob)`` pairs as
multipart [topic, meta-json, blob?], so subscribers filter by topic
prefix.

Failure discipline (as ``publish/mqtt.py``): a publisher never takes
down its stream. The first bind or connect raises ``ValueError`` (a 400
at the REST layer: a misconfigured destination fails its start
request); after that a message a subscriber's high-water mark refuses
is dropped, a broken socket is rebuilt with bounded backoff, and every
drop is counted (``evam_publish_dropped{dest="zmq"}``).
"""

from __future__ import annotations

import json
import logging
import threading
import time

from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.publish.zmq")


class ZmqDestination:
    #: the publishing stream thread increments, /streams snapshots
    #: read — guarded by ``_lock``
    SHARED_UNDER = {"_dropped": "_lock"}

    def __init__(
        self,
        endpoint: str = "tcp://127.0.0.1:65114",
        topic: str = "evam_tpu",
        bind: bool = True,
        send_hwm: int = 1000,
        max_backoff_s: float = 10.0,
    ):
        self.topic = topic.encode()
        self.endpoint = endpoint
        self.bind = bind
        self.send_hwm = send_hwm
        self.max_backoff_s = max_backoff_s
        self._lock = threading.Lock()
        self._dropped = 0
        self._backoff = 0.5
        self._next_retry = 0.0
        self._sock = None
        self._connect()

    def _connect(self) -> None:
        # imported here, as the reference imports zmq: the eii package
        # imports the server, which imports this package
        from evam_tpu_torch.eii.zmtp import PubSocket

        sock = PubSocket(hwm=self.send_hwm)
        try:
            if self.bind:
                sock.bind(self.endpoint)
            else:
                sock.connect(self.endpoint)
        except (OSError, ValueError) as exc:
            sock.close()
            raise ValueError(
                f"zmq destination endpoint {self.endpoint}: {exc}"
            ) from exc
        self._sock = sock
        log.info("zmq pub %s endpoint %s",
                 "bound" if self.bind else "connected", self.endpoint)

    def _ensure(self) -> bool:
        if self._sock is not None:
            return True
        if time.monotonic() < self._next_retry:
            return False
        try:
            self._connect()
            self._backoff = 0.5
            return True
        except ValueError as exc:
            self._next_retry = time.monotonic() + self._backoff
            self._backoff = min(self._backoff * 2, self.max_backoff_s)
            log.warning("zmq reconnect failed (%s); retry in %.1fs",
                        exc, self._backoff)
            return False

    def _drop(self) -> None:
        with self._lock:
            self._dropped += 1
        metrics.inc("evam_publish_dropped", labels={"dest": "zmq"})

    def publish(self, meta: dict, frame: bytes | None = None) -> None:
        if not self._ensure():
            self._drop()
            return
        parts = [self.topic, json.dumps(meta, separators=(",", ":")).encode()]
        if frame is not None:
            parts.append(frame)
        try:
            refused = self._sock.send_multipart(parts)
        except RuntimeError as exc:  # the socket's I/O thread is gone
            log.warning("zmq publish failed (%s); rebuilding socket", exc)
            self._sock.close()
            self._sock = None
            self._next_retry = time.monotonic() + self._backoff
            self._backoff = min(self._backoff * 2, self.max_backoff_s)
            self._drop()
            return
        if refused:
            self._drop()  # a subscriber's high-water mark: slow consumer

    @property
    def dropped(self) -> int:
        return self._dropped

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
