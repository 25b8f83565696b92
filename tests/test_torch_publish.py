"""The port's destinations (``evam_tpu_torch.publish``) against the
reference's (``evam_tpu.publish``): the same inputs through both, and
the bytes that reach the broker, the file or stdout compared exactly.

* MQTT: the same in-test broker as ``tests/test_publish.py`` records
  every packet (CONNECT, PUBLISH, DISCONNECT) of each client; with the
  client id set alike, the packet streams are equal. An unreachable broker drops and counts, never raises.
* file (json-lines and json) and stdout: equal bytes; a write failure
  drops, counts, and recovers as the reference's does.
* the factory: the same classes for the same configurations; an
  unknown type raises ValueError in both; zmq raises naming its slice.
"""

from __future__ import annotations

import json
import time

import pytest
from test_publish import FakeBroker  # the reference's in-test broker

from evam_tpu.publish import base as ref_base
from evam_tpu.publish import mqtt as ref_mqtt
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.publish import base as port_base
from evam_tpu_torch.publish import file_dest as port_file
from evam_tpu_torch.publish import mqtt as port_mqtt

#: a frame's metadata as metaconvert publishes it (floats, nesting,
#: non-ASCII), and a frame blob
META = [
    {"objects": [{"detection": {"bounding_box": {
        "x_min": 0.125, "y_min": 0.25, "x_max": 0.6180339887, "y_max": 1.0},
        "confidence": 0.7310585975646973, "label": "person", "label_id": 1},
        "h": 120, "roi_type": "person", "w": 64, "x": 16, "y": 30}],
     "resolution": {"height": 480, "width": 640},
     "source": "synthetic://640x480@30", "tags": {"caméra": "entrée"},
     "timestamp": 33333333},
    {"objects": [], "resolution": {"height": 480, "width": 640},
     "timestamp": 66666666},
]
FRAME = bytes(range(256)) * 3


class RecordingBroker(FakeBroker):
    """FakeBroker that also keeps every packet it reads, in order."""

    def __init__(self):
        self.packets: list[tuple[int, bytes]] = []
        super().__init__()

    def _read_packet(self, conn):
        pkt = super()._read_packet(conn)
        if pkt is not None:
            self.packets.append(pkt)
        return pkt


def _mqtt_packets(base_module) -> tuple[list, list]:
    broker = RecordingBroker()
    dest = base_module.create_destination(
        {"type": "mqtt", "host": f"127.0.0.1:{broker.port}", "topic": "evam/t"})
    # the default client id carries the clock
    dest._client.client_id = "evam-test"
    dest.publish(META[0], frame=FRAME)
    dest.publish(META[1])
    dest.close()
    broker.thread.join(timeout=5)
    assert not broker.thread.is_alive()
    return broker.packets, broker.published


def test_mqtt_wire_bytes_equal_the_references():
    ref_packets, ref_published = _mqtt_packets(ref_base)
    got_packets, got_published = _mqtt_packets(port_base)
    assert [p[0] >> 4 for p in got_packets] == [1, 3, 3, 3, 14]
    assert got_packets == ref_packets
    assert [t for t, _ in got_published] == ["evam/t", "evam/t/frames", "evam/t"]
    assert json.loads(got_published[0][1]) == META[0]
    assert got_published[1][1] == FRAME
    assert got_published == ref_published


def test_mqtt_default_topic_and_client_are_the_references():
    ref = ref_base.create_destination({"type": "mqtt", "host": "h"})
    got = port_base.create_destination({"type": "mqtt", "host": "h"})
    assert isinstance(got, port_mqtt.MqttDestination)
    assert isinstance(ref, ref_mqtt.MqttDestination)
    assert (got.topic, got._client.host, got._client.port,
            got._client.keepalive) == (ref.topic, ref._client.host,
                                       ref._client.port, ref._client.keepalive)


def test_mqtt_unreachable_broker_drops_not_raises():
    before = metrics.get_counter("evam_publish_dropped", labels={"dest": "mqtt"})
    dest = port_mqtt.MqttDestination("127.0.0.1", 1, topic="x", max_backoff=0.1)
    for _ in range(3):
        dest.publish({"n": 1})
    assert dest.dropped >= 1
    assert metrics.get_counter(
        "evam_publish_dropped", labels={"dest": "mqtt"}) - before == dest.dropped
    dest.close()


@pytest.mark.parametrize("fmt", ["json-lines", "json"])
def test_file_bytes_equal_the_references(tmp_path, fmt):
    written = []
    for name, module in (("ref", ref_base), ("port", port_base)):
        path = tmp_path / f"{name}.out"
        dest = module.create_destination(
            {"type": "file", "path": str(path), "format": fmt})
        for meta in META:
            dest.publish(meta, frame=FRAME)
        dest.close()
        written.append(path.read_bytes())
    assert written[1] == written[0]
    rows = ([json.loads(x) for x in written[1].decode().splitlines()]
            if fmt == "json-lines" else json.loads(written[1]))
    assert rows == META


def test_stdout_bytes_equal_the_references(capsys):
    printed = []
    for module in (ref_base, port_base):
        dest = module.create_destination({"type": "stdout"})
        for meta in META:
            dest.publish(meta)
        dest.close()
        printed.append(capsys.readouterr().out)
    assert isinstance(port_base.create_destination({"type": "stdout"}),
                      port_file.StdoutDestination)
    assert printed[1] == printed[0]
    assert [json.loads(x) for x in printed[1].splitlines()] == META


def test_file_write_failure_drops_counts_and_recovers(tmp_path):
    missing = tmp_path / "not-yet"
    before = metrics.get_counter("evam_publish_dropped", labels={"dest": "file"})
    dest = port_file.FileDestination(str(missing / "r.jsonl"),
                                     retry_backoff_s=0.1, max_backoff_s=0.5)
    dest.publish({"a": 1})  # the open fails: dropped, not raised
    dest.publish({"a": 2})  # inside the backoff window: dropped too
    assert dest.dropped == 2
    assert metrics.get_counter(
        "evam_publish_dropped", labels={"dest": "file"}) - before == 2
    missing.mkdir()
    time.sleep(0.25)  # past the doubled backoff
    dest.publish({"a": 3})
    dest.close()
    assert [json.loads(x) for x in
            (missing / "r.jsonl").read_text().splitlines()] == [{"a": 3}]
    assert dest.dropped == 2


@pytest.mark.parametrize("cfg", [
    None, {}, {"type": "null"}, {"type": "appsink"}, {"type": "application"},
    {"type": "file", "path": "x.jsonl"}, {"type": "stdout"},
    {"type": "mqtt", "host": "broker:1884", "topic": "t"},
])
def test_factory_picks_the_references_destination(cfg):
    ref = ref_base.create_destination(cfg)
    got = port_base.create_destination(cfg)
    assert type(got).__name__ == type(ref).__name__
    got.close()
    ref.close()


def test_factory_refusals():
    for module in (ref_base, port_base):
        with pytest.raises(ValueError, match="carrier-pigeon"):
            module.create_destination({"type": "carrier-pigeon"})
    with pytest.raises(NotImplementedError, match="slice 11"):
        port_base.create_destination({"type": "zmq", "endpoint": "tcp://x:1"})
