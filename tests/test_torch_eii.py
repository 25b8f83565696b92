"""EII mode of the port (``evam_tpu_torch.eii``, ``publish/encode.py``,
``publish/zmq_dest.py``, ``media/source.py::AppSource``) against the
reference (``evam_tpu.eii``) and against pyzmq.

* The wire (``eii/zmtp.py``): the port's PUB and SUB against pyzmq's,
  both ways, over tcp and ipc, the port binding and connecting;
  multipart with and without a blob, prefix filtering, unsubscribe, a
  6.2 MB frame byte-equal; ZMTP 3.1's SUBSCRIBE/CANCEL commands; a
  peer of the wrong socket type refused; a subscriber that never reads
  costs drops, not time (10,000 publishes within 5 s).
* The message bus: the port's publisher and subscriber against the
  reference's, each way, with equal ``(meta, blob)``.
* ``encode_frame``: ``raw`` and ``jpeg`` byte-equal to the reference's;
  the port's PNG decoded by cv2 equals the frame at every level 0–9,
  cv2's PNG (every row filter) decoded by the port's ``decode_frame``
  equals it, odd widths and 1×1 included; the errors equal.
* ``ConfigMgr``: file, watch, etcd through a fake gateway, a dead
  gateway falling back to the file; the dicts equal the reference's.
* ``EiiManager`` in both source modes (decoder → bus, bus → AppSource
  → bus), 64×64 and width 8, the same weights (the reference saves its
  parameters into a models dir both registries read): the same frames
  give the same ``gva_meta`` and objects as the reference's manager —
  labels and label ids equal, confidences and normalized boxes within
  1e-4 (float32, the tolerance of ``tests/test_torch_slice.py``), pixel
  rects within 1 px of each other (the same boxes rounded) — and every
  message has the shape of ``tests/golden/message_eii_msgbus.json``.
  Each manager's pipeline start is held until a probe on its own
  publisher reaches the test's subscriber: a PUB drops what it sends
  before a subscription arrives (pub/sub's slow joiner).
* Hot reload: a changed topic restarts on the new topic; a bad config
  falls back to the last good one with ``reload_error`` set.
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import tempfile
import time
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import zmq
from test_eii import _FakeEtcdGateway
from test_golden import canonical  # read-only use: never check_golden

from evam_tpu.config import settings as ref_settings
from evam_tpu.eii import configmgr as ref_configmgr
from evam_tpu.eii import manager as ref_manager
from evam_tpu.eii import msgbus as ref_msgbus
from evam_tpu.engine import EngineHub as JaxHub
from evam_tpu.models import ModelRegistry as JaxRegistry
from evam_tpu.parallel import build_mesh
from evam_tpu.publish import encode as ref_encode
from evam_tpu.server.registry import PipelineRegistry as JaxPipelineRegistry
from evam_tpu.stages.context import FrameContext as RefFrameContext
from evam_tpu.stages.context import Region as RefRegion
from evam_tpu.stages.context import Tensor as RefTensor
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.eii import configmgr, manager, msgbus, zmtp
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.media.source import AppSource, SyntheticSource, create_source
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.publish import encode
from evam_tpu_torch.server.registry import PipelineRegistry
from evam_tpu_torch.stages.context import FrameContext, Region, Tensor

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
KEY = "object_detection/person_vehicle_bike"
GOLDEN = json.loads((REPO / "tests" / "golden"
                     / "message_eii_msgbus.json").read_text())
BIG = 1080 * 1920 * 3  # one 1080p BGR frame: 6.2 MB


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sock_dir() -> str:
    """A short directory for AF_UNIX paths (107 bytes at most; pytest's
    tmp_path can be longer)."""
    return tempfile.mkdtemp(prefix="eii", dir="/tmp")


def _until(fn, timeout: float = 10.0):
    deadline = time.time() + timeout
    while True:
        got = fn()
        if got:
            return got
        assert time.time() < deadline, "timed out"
        time.sleep(0.01)


# ------------------------------------------------------------- the wire


def _pyzmq(kind, hwm: int = 1000):
    sock = zmq.Context.instance().socket(kind)
    sock.setsockopt(zmq.LINGER, 0)
    sock.setsockopt(zmq.RCVTIMEO, 100)
    sock.setsockopt(zmq.SNDHWM if kind == zmq.PUB else zmq.RCVHWM, hwm)
    return sock


def _zrecv(sock):
    try:
        return sock.recv_multipart()
    except zmq.Again:
        return None


def _endpoint(transport: str) -> str:
    if transport == "tcp":
        return f"tcp://127.0.0.1:{_free_port()}"
    return f"ipc://{_sock_dir()}/bus"


def _pair(transport: str, port_binds: bool, port_publishes: bool):
    """(send, recv, close) over one port socket and one pyzmq socket,
    joined: probes are published until one arrives."""
    ep = _endpoint(transport)
    if port_publishes:
        port = zmtp.PubSocket()
        other = _pyzmq(zmq.SUB)
        other.setsockopt(zmq.SUBSCRIBE, b"t")
        send, recv = port.send_multipart, lambda: _zrecv(other)
    else:
        port = zmtp.SubSocket(rcvtimeo_ms=100)
        port.subscribe(b"t")
        other = _pyzmq(zmq.PUB)
        send, recv = other.send_multipart, port.recv_multipart
    if port_binds:
        port.bind(ep)
        other.connect(ep)
    else:
        other.bind(ep)
        port.connect(ep)

    def joined():
        send([b"t", b"probe"])
        return recv()

    _until(joined)

    def close():
        port.close()
        other.close()
    return send, recv, close


def _drain(recv) -> list:
    """Every message until a receive times out, probes left out."""
    out = []
    while (msg := recv()) is not None:
        if msg[1:] != [b"probe"]:
            out.append(msg)
    return out


@pytest.mark.parametrize("port_publishes", [True, False],
                         ids=["port-pub", "port-sub"])
@pytest.mark.parametrize("port_binds", [True, False],
                         ids=["port-binds", "port-connects"])
@pytest.mark.parametrize("transport", ["tcp", "ipc"])
def test_wire_interoperates_with_pyzmq(transport, port_binds, port_publishes):
    send, recv, close = _pair(transport, port_binds, port_publishes)
    try:
        send([b"t", b'{"n":1}', b"\x00\x01blob"])
        send([b"other", b"filtered out"])
        send([b"tz", b'{"n":2}'])
        send([b"t", b""])
        assert _drain(recv) == [[b"t", b'{"n":1}', b"\x00\x01blob"],
                                [b"tz", b'{"n":2}'], [b"t", b""]]
    finally:
        close()


@pytest.mark.parametrize("port_publishes", [True, False],
                         ids=["port-pub", "port-sub"])
def test_a_1080p_frame_crosses_byte_equal(port_publishes):
    blob = np.random.default_rng(0).integers(
        0, 256, BIG, np.uint8).tobytes()
    send, recv, close = _pair("tcp", True, port_publishes)
    try:
        send([b"t", b"{}", blob])
        assert _drain(recv) == [[b"t", b"{}", blob]]
    finally:
        close()


def test_unsubscribe_stops_delivery():
    pub = _pyzmq(zmq.PUB)
    sub = zmtp.SubSocket(rcvtimeo_ms=100)
    sub.subscribe(b"t")
    sub.subscribe(b"t")  # counted: one unsubscribe leaves one
    ep = _endpoint("ipc")
    pub.bind(ep)
    sub.connect(ep)
    try:
        _until(lambda: pub.send_multipart([b"t", b"probe"])
               or sub.recv_multipart())
        sub.unsubscribe(b"t")
        pub.send_multipart([b"t", b"kept"])
        assert _drain(sub.recv_multipart) == [[b"t", b"kept"]]
        sub.unsubscribe(b"t")
        # an in-band barrier: the publisher applies one connection's
        # subscription commands in order, so once a message on a topic
        # subscribed after the cancel arrives, the cancel is in force
        sub.subscribe(b"m")
        _until(lambda: pub.send_multipart([b"m", b"probe"])
               or sub.recv_multipart())
        pub.send_multipart([b"t", b"gone"])
        pub.send_multipart([b"m", b"marker"])
        assert _drain(sub.recv_multipart) == [[b"m", b"marker"]]
    finally:
        sub.close()
        pub.close()


class _RawPeer:
    """A hand-driven ZMTP peer: greeting, READY, then frames."""

    def __init__(self, port: int, socket_type: bytes, minor: int = 1):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        greeting = bytearray(zmtp.GREETING)
        greeting[11] = minor
        self.sock.sendall(bytes(greeting))
        self.buf = b""
        self.greeting = self._read(64)
        self.send(zmtp._command(b"READY", zmtp._properties(
            {b"Socket-Type": socket_type})))

    def _read(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("closed by the peer")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def send(self, bufs) -> None:
        self.sock.sendall(b"".join(bufs))

    def frame(self) -> tuple[int, bytes]:
        flags = self._read(1)[0]
        n = (int.from_bytes(self._read(8), "big") if flags & zmtp.LONG
             else self._read(1)[0])
        return flags, self._read(n)


def test_pub_takes_zmtp31_subscribe_and_cancel_commands():
    pub = zmtp.PubSocket()
    port = int(pub.bind("tcp://127.0.0.1:*").rsplit(":", 1)[1])
    peer = _RawPeer(port, b"SUB", minor=1)
    try:
        assert peer.greeting[:12] == zmtp.GREETING[:12]  # announces 3.0
        flags, body = peer.frame()
        assert flags & zmtp.COMMAND and body[1:6] == b"READY"
        assert b"Socket-Type\x00\x00\x00\x03PUB" in body
        peer.send(zmtp._command(b"SUBSCRIBE", b"ab"))
        _until(pub.subscribed_peers)
        pub.send_multipart([b"abc", b"x"])
        pub.send_multipart([b"b", b"y"])
        assert [peer.frame(), peer.frame()] == [
            (zmtp.MORE, b"abc"), (0, b"x")]
        peer.send(zmtp._command(b"CANCEL", b"ab"))
        _until(lambda: not pub.subscribed_peers())
        assert pub.peers() == 1
    finally:
        peer.sock.close()
        pub.close()


def test_a_peer_of_the_wrong_type_is_refused():
    """A PUB meeting a PUB closes the connection after the handshake."""
    pub = zmtp.PubSocket()
    port = int(pub.bind("tcp://127.0.0.1:*").rsplit(":", 1)[1])
    sock = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        sock.sendall(zmtp.GREETING + b"".join(zmtp._command(
            b"READY", zmtp._properties({b"Socket-Type": b"PUB"}))))
        try:
            while sock.recv(65536):
                pass
        except socket.timeout:
            pytest.fail("the connection stayed open")
        except ConnectionError:
            pass  # reset: closed with our bytes unread
        assert pub.peers() == 0
    finally:
        sock.close()
        pub.close()


def test_a_subscriber_that_never_reads_costs_drops_not_time():
    """A peer that subscribes and then never reads: its queue fills to
    the high-water mark behind a full socket buffer, and every later
    publish drops for it at once."""
    pub = zmtp.PubSocket(hwm=100)
    port = int(pub.bind("tcp://127.0.0.1:*").rsplit(":", 1)[1])
    peer = _RawPeer(port, b"SUB", minor=0)
    peer.send(zmtp._frame(b"\x01"))  # every topic, the 3.0 form
    _until(pub.subscribed_peers)
    payload = b"x" * 65536
    try:
        t0 = time.perf_counter()
        dropped = sum(pub.send_multipart([b"t", payload])
                      for _ in range(10_000))
        elapsed = time.perf_counter() - t0
        assert elapsed < 5.0, elapsed
        assert 0 < dropped < 10_000
    finally:
        peer.sock.close()
        t0 = time.perf_counter()
        pub.close()
        assert time.perf_counter() - t0 < 5.0
    assert not pub._thread.is_alive()


def test_receive_timeout_and_close():
    d = _sock_dir()
    pub = zmtp.PubSocket()
    pub.bind(f"ipc://{d}/x")
    sub = zmtp.SubSocket(rcvtimeo_ms=50)
    sub.subscribe(b"")
    sub.connect(f"ipc://{d}/x")
    t0 = time.perf_counter()
    assert sub.recv_multipart() is None
    assert 0.04 < time.perf_counter() - t0 < 2.0
    _until(pub.peers)
    sub.close()
    pub.close()
    assert not sub._thread.is_alive() and not pub._thread.is_alive()
    assert not Path(d, "x").exists()  # the bound socket file is removed
    with pytest.raises(RuntimeError):
        pub.send_multipart([b"t"])


@pytest.mark.parametrize("endpoint", [
    "bogus://x", "tcp://127.0.0.1", "tcp://127.0.0.1:notaport",
    "tcp://127.0.0.1:70000", "nothing"])
def test_malformed_endpoints_raise_value_error(endpoint):
    sock = zmtp.PubSocket()
    try:
        with pytest.raises(ValueError):
            sock.bind(endpoint)
        with pytest.raises(ValueError):
            sock.connect(endpoint)
    finally:
        sock.close()


# ---------------------------------------------------------- message bus


@pytest.mark.parametrize("bus_type", ["zmq_ipc", "zmq_tcp"])
@pytest.mark.parametrize("blob", [None, b"\x07" * 300], ids=["meta", "blob"])
@pytest.mark.parametrize("port_publishes", [True, False],
                         ids=["port-pub", "ref-pub"])
def test_msgbus_against_the_references(bus_type, blob, port_publishes):
    cfg = ({"Type": "zmq_ipc", "EndPoint": _sock_dir()}
           if bus_type == "zmq_ipc"
           else {"Type": "zmq_tcp", "EndPoint": f"127.0.0.1:{_free_port()}"})
    pub_mod, sub_mod = ((msgbus, ref_msgbus) if port_publishes
                        else (ref_msgbus, msgbus))
    pub = pub_mod.MsgBusPublisher(cfg, "cam1")
    sub = sub_mod.MsgBusSubscriber(cfg, "cam1", recv_timeout_ms=100)
    meta = {"width": 4, "height": 2, "gva_meta": [], "caméra": "entrée"}
    try:
        _until(lambda: pub.publish({"probe": 1}) or sub.recv())
        pub.publish(meta, blob)
        got = [m for m in iter(sub.recv, None) if "probe" not in m[0]]
        assert got == [(meta, blob)]
    finally:
        sub.close()
        pub.close()


def test_msgbus_endpoints_are_the_references(monkeypatch):
    d = _sock_dir()
    for cfg, bind in [({"Type": "zmq_tcp", "EndPoint": "0.0.0.0:5555"}, True),
                      ({"Type": "zmq_tcp", "EndPoint": "0.0.0.0:5555"}, False),
                      ({"Type": "zmq_tcp"}, False),
                      ({"Type": "zmq_ipc", "EndPoint": d}, True)]:
        assert msgbus._endpoint(cfg, "t", bind) == \
            ref_msgbus._endpoint(cfg, "t", bind)
    for module in (msgbus, ref_msgbus):
        with pytest.raises(ValueError, match="unsupported msgbus type"):
            module._endpoint({"Type": "mqtt"}, "t", True)
    assert msgbus.SOCKET_DIR == ref_msgbus.SOCKET_DIR


# ------------------------------------------------------------- encoding

_SIZES = [(1, 1), (3, 5), (17, 33), (64, 97)]


def _frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("h,w", _SIZES)
def test_raw_and_jpeg_bytes_equal_the_references(h, w):
    f = _frame(h, w)
    for enc, level in [(None, None), ("raw", None), ("jpeg", None),
                       ("jpeg", 70)]:
        assert encode.encode_frame(f, enc, level) == \
            ref_encode.encode_frame(f, enc, level)
    jpeg = encode.encode_frame(f, "jpeg", 90)
    np.testing.assert_array_equal(
        encode.decode_frame(jpeg, "jpeg"),
        cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("h,w", _SIZES)
def test_png_is_pixel_equal_both_ways_at_every_level(h, w):
    f = _frame(h, w)
    for level in [None, *range(10)]:
        ours = encode.encode_frame(f, "png", level)
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_COLOR), f)
        np.testing.assert_array_equal(encode.decode_frame(ours, "png"), f)
        theirs = ref_encode.encode_frame(f, "png", level)
        np.testing.assert_array_equal(encode.decode_frame(theirs, "png"), f)


def _png_chunks(blob: bytes):
    pos = 8
    while pos < len(blob):
        size, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        yield kind, blob[pos + 8:pos + 8 + size]
        pos += 12 + size


def test_decode_reads_every_row_filter():
    """cv2 (libpng) picks a filter per row: on running sums of noise at
    level 9 it uses all five; the port decodes the result exactly."""
    f = np.cumsum(_frame(64, 65, seed=3), axis=1).astype(np.uint8)
    blob = ref_encode.encode_frame(f, "png", 9)
    idat = b"".join(chunk for kind, chunk in _png_chunks(blob)
                    if kind == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(64, -1)
    assert set(rows[:, 0].tolist()) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(encode.decode_frame(blob, "png"), f)


def test_encoding_errors_are_the_references(monkeypatch):
    f = _frame(4, 4)
    for enc, level in [("png", -1), ("png", 10), ("jpeg", 101),
                       ("jpeg", -1), ("webp", None)]:
        with pytest.raises(ValueError) as ref_exc:
            ref_encode.encode_frame(f, enc, level)
        with pytest.raises(ValueError) as port_exc:
            encode.encode_frame(f, enc, level)
        assert str(port_exc.value) == str(ref_exc.value)
    with pytest.raises(ValueError, match="not a PNG"):
        encode.decode_frame(b"GIF89a", "png")
    # no cv2 (the card's machine): raw, png and jpeg need none of it;
    # jpeg goes through the port's codec, to the reference's bytes
    want = ref_encode.encode_frame(f, "jpeg", 90)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert encode.encode_frame(f, "raw") == f.tobytes()
    np.testing.assert_array_equal(
        encode.decode_frame(encode.encode_frame(f, "png"), "png"), f)
    assert encode.encode_frame(f, "jpeg", 90) == want
    assert encode.decode_frame(want, "jpeg").shape == (4, 4, 3)
    with pytest.raises(ValueError, match="jpeg: truncated"):
        encode.decode_frame(b"\xff\xd8", "jpeg")


# ------------------------------------------------------------ ConfigMgr


def test_configmgr_defaults_and_file_equal_the_references(tmp_path):
    ref, port = ref_configmgr.ConfigMgr(), configmgr.ConfigMgr()
    assert port._data == ref._data
    assert configmgr.DEFAULT_CONFIG == ref_configmgr.DEFAULT_CONFIG
    f = tmp_path / "config.json"
    f.write_text(json.dumps({
        "config": {"pipeline": "video_decode/app_dst"},
        "interfaces": {"Publishers": [{"Name": "a", "Type": "zmq_ipc"}],
                       "Subscribers": [{"Name": "b", "Type": "zmq_tcp"}]},
    }))
    ref, port = ref_configmgr.ConfigMgr(f), configmgr.ConfigMgr(f)
    for name in ("get_app_config", "get_num_publishers",
                 "get_num_subscribers"):
        assert getattr(port, name)() == getattr(ref, name)()
    assert port.get_publisher_by_index(0) == ref.get_publisher_by_index(0)
    assert port.get_subscriber_by_index(0) == ref.get_subscriber_by_index(0)


def test_configmgr_watches_its_file(tmp_path):
    f = tmp_path / "config.json"
    f.write_text(json.dumps({"config": {"pipeline": "a/b"}}))
    cfg = configmgr.ConfigMgr(f, watch_interval_s=0.05)
    seen = []
    cfg.watch(seen.append)
    try:
        time.sleep(0.1)
        f.write_text(json.dumps({"config": {"pipeline": "c/d"}}))
        _until(lambda: seen)
        assert seen[0]["config"]["pipeline"] == "c/d"
        assert cfg.get_app_config() == {"pipeline": "c/d"}
    finally:
        cfg.close()


def test_configmgr_reads_and_watches_etcd_as_the_reference():
    gw = _FakeEtcdGateway()
    try:
        gw.put("/evam_tpu/config", {"pipeline": "video_decode/app_dst"})
        gw.put("/evam_tpu/interfaces", {"Publishers": [], "Subscribers": []})
        env = {"EVAM_ETCD_HOST": "127.0.0.1", "ETCD_CLIENT_PORT": str(gw.port)}
        port_store = configmgr.EtcdGatewayStore.from_env(env)
        ref_store = ref_configmgr.EtcdGatewayStore.from_env(env)
        assert vars(port_store) == vars(ref_store)
        assert port_store.load() == ref_store.load()
        assert port_store.version() == ref_store.version()
        cfg = configmgr.ConfigMgr(etcd=port_store, watch_interval_s=0.05)
        seen = []
        cfg.watch(seen.append)
        try:
            assert cfg.etcd is port_store
            time.sleep(0.1)
            gw.put("/evam_tpu/config", {"pipeline": "object_detection/person"})
            _until(lambda: seen)
            assert seen[0]["config"] == {"pipeline": "object_detection/person"}
        finally:
            cfg.close()
    finally:
        gw.close()


def test_etcd_from_env_is_the_references():
    for env in [{}, {"ETCD_HOST": "h"},
                {"EVAM_ETCD_HOST": "e", "ETCD_HOST": "h", "ETCD_PREFIX": "/p",
                 "CONFIGMGR_CACERT": "", "ETCD_CLIENT_PORT": "2400"}]:
        port = configmgr.EtcdGatewayStore.from_env(env)
        ref = ref_configmgr.EtcdGatewayStore.from_env(env)
        assert (port is None) == (ref is None)
        if port is not None:
            assert vars(port) == vars(ref)


def test_a_dead_gateway_falls_back_to_the_file(tmp_path):
    f = tmp_path / "config.json"
    f.write_text(json.dumps({"config": {"pipeline": "video_decode/app_dst"}}))
    cfg = configmgr.ConfigMgr(
        f, etcd=configmgr.EtcdGatewayStore("127.0.0.1", port=1,
                                           timeout_s=0.2))
    assert cfg.etcd is None
    assert cfg.get_app_config() == {"pipeline": "video_decode/app_dst"}


# ------------------------------------------------------------ AppSource


def test_app_source_drops_oldest_and_ends():
    src = create_source({"type": "application", "queue-size": 2})
    assert isinstance(src, AppSource)
    for i in range(3):
        src.push(np.full((2, 2, 3), i, np.uint8), pts_ns=i)
    src.push_raw(np.full((2, 2, 3), 9, np.uint8).tobytes(), 2, 2, pts_ns=9)
    src.end()
    got = [(ev.seq, ev.pts_ns, int(ev.frame[0, 0, 0])) for ev in src.frames()]
    assert got == [(2, 2, 2), (3, 9, 9)]
    with pytest.raises(RuntimeError):
        src.push(np.zeros((2, 2, 3), np.uint8))


# ---------------------------------------------------------- the manager


def test_gva_meta_holds_the_golden():
    """The golden's own region (tracked, classified) through both
    packages' ``_gva_meta``: equal, and canonical-equal to the golden's
    ``gva_meta``."""
    def ctx(ctx_cls, region_cls, tensor_cls):
        c = ctx_cls(frame=np.zeros((64, 96, 3), np.uint8), pts_ns=123,
                    seq=1, stream_id="cam1")
        r = region_cls(0.1, 0.2, 0.5, 0.8, 0.9, 1, "person")
        r.object_id = 7
        r.tensors.append(tensor_cls(name="color", confidence=0.8,
                                    label_id=2, label="white"))
        c.regions = [r]
        return c

    got = manager._gva_meta(ctx(FrameContext, Region, Tensor))
    assert got == ref_manager._gva_meta(ctx(RefFrameContext, RefRegion,
                                            RefTensor))
    assert canonical(got) == GOLDEN["gva_meta"]


def _shape_errors(got, want, path="$") -> list[str]:
    """Where canonical ``got`` leaves the golden's shape ``want``: the
    same keys, ``<num>`` where it has one, a string where it has a
    string (a label is data: any label passes); a list's every element
    against its first (``chip_smoke.py``'s check)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{path}: {got}"]
        return [e for k in want for e in _shape_errors(got[k], want[k],
                                                       f"{path}.{k}")]
    if isinstance(want, list):
        if not isinstance(got, list):
            return [f"{path}: not a list"]
        return [e for g in got for e in _shape_errors(g, want[0], path + "[]")]
    if want == "<num>":
        return [] if got == "<num>" else [f"{path}: {got!r}"]
    return [] if isinstance(got, str) and not got.startswith("<") or \
        got == "<str>" else [f"{path}: {got!r}"]


def _message_errors(meta: dict) -> list[str]:
    """An EII message against ``message_eii_msgbus.json``: the golden's
    keys in the golden's shape (the message carries more: the frame's
    EVA-schema fields and the encoding), every region checked, the
    image handle 12 hex digits. A region's ``object_id`` is null where
    no tracker runs, in the reference's messages as in the port's: it
    is checked as a number only where it is set."""
    missing = set(GOLDEN) - set(meta)
    if missing:
        return [f"missing {sorted(missing)}"]
    sub = {k: meta[k] for k in GOLDEN}
    sub["gva_meta"] = [{**g, "object_id": 0 if g.get("object_id") is None
                        else g["object_id"]} for g in meta["gva_meta"]]
    errors = [] if sub["gva_meta"] else ["no region"]
    errors += _shape_errors(canonical(sub), GOLDEN)
    handle = meta["img_handle"]
    if not (isinstance(handle, str) and len(handle) == 12
            and int(handle, 16) >= 0):
        errors.append(f"img_handle {handle!r}")
    return errors


class _Hold:
    """Holds a manager's pipeline start until a probe published on the
    manager's own publisher reaches ``subscriber`` (a PUB drops what it
    sends before a subscription arrives)."""

    def __init__(self, registry, subscriber):
        self.subscriber = subscriber
        self.start = registry.start_instance
        registry.start_instance = self

    def __call__(self, name, version, request, publish_fn=None, **kw):
        publisher = publish_fn.__self__.publisher
        _until(lambda: publisher.publish({"probe": True})
               or self.subscriber.recv(), timeout=30)
        return self.start(name, version, request, publish_fn=publish_fn,
                          **kw)


def _halt(mgr) -> None:
    """Stop a manager without stopping its registry's shared hub."""
    mgr._stop.set()
    if mgr.app_source is not None:
        mgr.app_source.end()
    mgr._teardown_ingest()
    mgr.cfg.close()
    if mgr.instance is not None:
        mgr.registry.stop_instance(mgr.instance.id)
        mgr.instance.wait(timeout=30)
    mgr.publisher.close()


@pytest.fixture(scope="module")
def registries(tmp_path_factory):
    """The reference's and the port's pipeline registries on the same
    seeded weights (the reference saves them into a models dir that
    both read), 64×64, width 8, float32, batch 1."""
    models = tmp_path_factory.mktemp("models")
    small = {KEY: (64, 64)}
    jreg = JaxRegistry(models_dir=models, dtype="float32",
                       input_overrides=small, width_overrides={KEY: 8},
                       allow_random_weights=True)
    jreg.get(KEY)
    jreg.save_weights(KEY)
    ref = JaxPipelineRegistry(
        ref_settings.Settings(pipelines_dir=str(REPO / "pipelines")),
        hub=JaxHub(jreg, plan=build_mesh(), max_batch=1, deadline_ms=1.0))
    treg = ModelRegistry(models_dir=models, dtype="float32", device="cpu",
                         input_overrides=small, width_overrides={KEY: 8})
    port = PipelineRegistry(
        Settings(pipelines_dir=str(REPO / "pipelines"), device="cpu"),
        hub=EngineHub(treg, device="cpu", max_batch=1, deadline_ms=1.0))
    yield {"ref": ref, "port": port}
    ref.stop_all()
    port.stop_all()


FRAMES = 6
_APP = {"pipeline": KEY, "publish_frame": True,
        "model_parameters": {"detection-properties": {"threshold": 0.0}}}


def _run_manager(which: str, registries, mode: str, sock_dir: str) -> list:
    """The manager of package ``which`` over FRAMES frames of a
    synthetic 96×64 video, from a decoder (``gstreamer``) or over the
    bus (``msgbus``, fed raw by the port's publisher); returns the
    (meta, blob) messages it published, in order."""
    mods = ((ref_configmgr, ref_manager, ref_msgbus) if which == "ref"
            else (configmgr, manager, msgbus))
    cfg_mod, mgr_mod, bus_mod = mods
    topic = f"results_{which}_{mode}"
    app = dict(_APP, source=mode)
    subscribers = []
    if mode == "gstreamer":
        app["source_parameters"] = {
            "type": "uri", "uri": f"synthetic://96x64@30?count={FRAMES}"}
        app["encoding"] = {"type": "png", "level": 3}
    else:
        subscribers = [{"Name": "in", "Type": "zmq_ipc",
                        "EndPoint": sock_dir, "Topics": [f"in_{which}"]}]
    f = Path(sock_dir) / f"{topic}.json"
    f.write_text(json.dumps({"config": app, "interfaces": {
        "Publishers": [{"Name": "default", "Type": "zmq_ipc",
                        "EndPoint": sock_dir, "Topics": [topic],
                        "AllowedClients": ["*"]}],
        "Subscribers": subscribers}}))
    sub = bus_mod.MsgBusSubscriber({"Type": "zmq_ipc", "EndPoint": sock_dir},
                                   topic, recv_timeout_ms=100)
    registry = registries[which]
    hold = _Hold(registry, sub)
    feeder = None
    try:
        mgr = mgr_mod.EiiManager(
            Settings(device="cpu") if which == "port"
            else ref_settings.Settings(),
            cfg_mgr=cfg_mod.ConfigMgr(f, watch_interval_s=60), registry=registry)
        def result():
            msg = sub.recv()
            return msg if msg is not None and "probe" not in msg[0] else None

        try:
            if mode == "gstreamer":
                return [_until(result, timeout=60) for _ in range(FRAMES)]
            feeder = msgbus.MsgBusPublisher(
                {"Type": "zmq_ipc", "EndPoint": sock_dir}, f"in_{which}")
            _until(feeder._sock.subscribed_peers)
            # paced as a camera sends (no engine queue forms, so no
            # staleness budget sheds a frame in either package)
            for ev in SyntheticSource(96, 64, count=FRAMES,
                                      realtime=True).frames():
                feeder.publish({"width": 96, "height": 64},
                               ev.frame.tobytes())
            # the runner keeps frames in flight until later frames or
            # the end of the stream release them: end it once the
            # ingest has pushed every frame
            _until(lambda: mgr.app_source._seq == FRAMES, timeout=60)
            mgr.app_source.end()
            return [_until(result, timeout=60) for _ in range(FRAMES)]
        finally:
            _halt(mgr)
    finally:
        registry.start_instance = hold.start
        sub.close()
        if feeder is not None:
            feeder.close()


def _rects_close(a: dict, b: dict) -> bool:
    return all(abs(a[k] - b[k]) <= 1 for k in ("x", "y", "width", "height"))


@pytest.mark.parametrize("mode", ["gstreamer", "msgbus"])
def test_manager_publishes_as_the_references(registries, mode):
    d = _sock_dir()
    drops0 = metrics.get_counter("evam_eii_ingest_drops")
    ref = _run_manager("ref", registries, mode, d)
    got = _run_manager("port", registries, mode, d)
    assert len(got) == len(ref) == FRAMES
    frames = [ev.frame for ev in SyntheticSource(96, 64,
                                                 count=FRAMES).frames()]
    n_objects = 0
    for (gm, gb), (rm, rb), frame in zip(got, ref, frames):
        assert _message_errors(gm) == [] and _message_errors(rm) == []
        assert (gm["width"], gm["height"], gm["caps"]) == (
            rm["width"], rm["height"], rm["caps"])
        if mode == "gstreamer":
            assert gm["encoding_type"] == rm["encoding_type"] == "png"
            assert gm["timestamp"] == rm["timestamp"]
            np.testing.assert_array_equal(encode.decode_frame(gb, "png"),
                                          frame)
            np.testing.assert_array_equal(
                cv2.imdecode(np.frombuffer(rb, np.uint8), cv2.IMREAD_COLOR),
                frame)
        else:
            assert gb == rb == frame.tobytes()
        g_objs, r_objs = gm["gva_meta"], rm["gva_meta"]
        assert [o["tensor"][0]["label"] for o in g_objs] == \
            [o["tensor"][0]["label"] for o in r_objs]
        for go, ro, gobj, robj in zip(g_objs, r_objs, gm["objects"],
                                      rm["objects"]):
            assert go["object_id"] is ro["object_id"] is None
            assert _rects_close(go, ro), (go, ro)
            for gt, rt in zip(go["tensor"], ro["tensor"]):
                assert (gt["name"], gt["label_id"]) == (rt["name"],
                                                        rt["label_id"])
                assert abs(gt["confidence"] - rt["confidence"]) <= 1e-4
            gb_, rb_ = (o["detection"]["bounding_box"] for o in (gobj, robj))
            assert all(abs(gb_[k] - rb_[k]) <= 1e-4 for k in rb_)
        n_objects += len(g_objs)
    assert n_objects > 0
    assert metrics.get_counter("evam_eii_ingest_drops") == drops0


def test_hot_reload_switches_topic_and_a_bad_reload_falls_back(registries):
    d = _sock_dir()
    app = {"source": "gstreamer", "pipeline": "video_decode/app_dst",
           "source_parameters": {"type": "uri",
                                 "uri": "synthetic://32x32@30?count=100000"},
           "publish_frame": False}

    def write(topic, extra=None):
        f.write_text(json.dumps({"config": {**app, **(extra or {})},
                                 "interfaces": {"Publishers": [{
                                     "Name": "default", "Type": "zmq_ipc",
                                     "EndPoint": d, "Topics": [topic]}]}}))

    f = Path(d) / "config.json"
    write("first")
    cfg = configmgr.ConfigMgr(f, watch_interval_s=0.05)
    mgr = manager.EiiManager(Settings(device="cpu"), cfg_mgr=cfg,
                             registry=registries["port"])
    try:
        first = mgr.instance
        sub = msgbus.MsgBusSubscriber({"Type": "zmq_ipc", "EndPoint": d},
                                      "second", recv_timeout_ms=100)
        try:
            time.sleep(0.1)  # a new mtime
            write("second")
            meta, _ = _until(sub.recv, timeout=30)
            assert meta["width"] == 32 and mgr.publisher.topic == "second"
            assert mgr.instance is not first and mgr.reload_error is None
        finally:
            sub.close()
        good = mgr.instance
        time.sleep(0.1)
        write("second", {"pipeline": "object_detection/no_such_pipeline"})
        _until(lambda: mgr.reload_error, timeout=30)
        assert "no_such_pipeline" in mgr.reload_error
        _until(lambda: mgr.instance is not None and mgr.instance is not good)
        assert mgr.instance.pipeline_name == "video_decode"
        assert mgr._last_good_cfg["pipeline"] == "video_decode/app_dst"
    finally:
        _halt(mgr)
