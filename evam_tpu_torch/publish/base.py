"""Destination protocol + factory.

Counterpart of ``evam_tpu/publish/base.py`` (a copy, less zmq).

The reference request body selects the metadata destination
(``destination: {metadata: {type: mqtt, host: ..., topic: ...}}``,
charts/templates/NOTES.txt:15-19; file type via gvametapublish
file-path in EVA samples). A destination receives the §6-schema
metadata dict per frame, and optionally the encoded frame bytes
(EII-mode ``(json, blob)`` framing, evas/publisher.py:246-250).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from evam_tpu_torch import slices


@runtime_checkable
class Destination(Protocol):
    def publish(self, meta: dict, frame: bytes | None = None) -> None: ...
    def close(self) -> None: ...


class NullDestination:
    """Swallows results (appsink-without-consumer equivalent)."""

    def publish(self, meta: dict, frame: bytes | None = None) -> None:
        pass

    def close(self) -> None:
        pass


def create_destination(cfg: dict | None) -> Destination:
    """Resolve a request ``destination.metadata`` object.

    Types: mqtt (host, topic, port), file (path, format), stdout,
    null; zmq (endpoint, topic) raises until the slice that brings it
    (the card's machine has no pyzmq). Unknown types raise ValueError —
    surfaced as a 400 by the REST layer like the reference's bad
    destination errors.
    """
    if not cfg:
        return NullDestination()
    dtype = cfg.get("type", "null")
    if dtype == "mqtt":
        from evam_tpu_torch.publish.mqtt import MqttDestination

        host = cfg.get("host", "localhost:1883")
        port = int(cfg.get("port", 0))
        if ":" in str(host) and not port:
            host, _, p = str(host).partition(":")
            port = int(p)
        return MqttDestination(
            host=host, port=port or 1883, topic=cfg.get("topic", "evam_tpu"),
        )
    if dtype == "file":
        from evam_tpu_torch.publish.file_dest import FileDestination

        return FileDestination(
            path=cfg.get("path", "/tmp/results.jsonl"),
            fmt=cfg.get("format", "json-lines"),
        )
    if dtype == "zmq":
        raise NotImplementedError(
            f"destination type 'zmq' comes with {slices.INGEST_EGRESS}")
    if dtype == "stdout":
        from evam_tpu_torch.publish.file_dest import StdoutDestination

        return StdoutDestination()
    if dtype in ("null", "appsink", "application"):
        return NullDestination()
    raise ValueError(f"unsupported destination type '{dtype}'")
