"""The port's WebRTC egress end to end, over real UDP and TCP on
127.0.0.1, with the reference (``evam_tpu/publish``, on
``cryptography``, ``websockets`` and cv2, all present here) on the other
side wherever one fits.

* Sessions: the reference's software viewer (the ``_Viewer`` of
  ``tests/test_rtc.py``, here ``publish/rtc/viewer.py`` over the
  reference's ``dtls``/``srtp``/``stun``/``rtcp``) against the port's
  ``RtcSession``: ICE, DTLS, every SRTP tag checked, VP8 reassembled;
  the 320×180 keyframe is the port encoder's bytes for that frame and
  libvpx decodes it to that encoder's reconstruction, exactly. The
  port's viewer against the reference's session. The feedback rules
  under ``TestLossRecovery``'s scripted traffic: a NACK answered with
  the identical protected packet, a PLI in delta mode followed by a
  keyframe, RR loss lowering ``fps_scale`` and clean RRs restoring it,
  RTT and jitter from an RR; a wrong DTLS fingerprint kills the
  session; an unreached session fires ``on_dead`` exactly once.
* Signalling: the reference's ``TestSignalingRelay`` scenario, with
  ``websockets`` clients, against ``python -m
  evam_tpu_torch.publish.rtc.signaling`` (and the ``bye`` on a viewer's
  disconnect); the port's websocket client against the reference's
  ``tools/signaling_server.py``; the port's websocket client and server
  against ``websockets``' server and client (fragments, ping → pong,
  close codes, masking).
* ``WebRtcSignaler``, the port's and the reference's against the same
  scripted signalling server: offer → answer (ice-lite, passive DTLS,
  nack/pli feedback), ``bye``, ``play`` (JPEGs the port's codec
  decodes) and ``stop``, each bringing the relay's client count back;
  a dropped connection reconnects and registers again; a failed answer
  is logged and the loop lives on.
* The whole path (the port's signalling server, signaler, sessions and
  two viewers on the port's primitives) in a subprocess where ``cv2``,
  ``cryptography`` and ``websockets`` cannot be imported: every payload
  received is the port encoder's bytes for a frame the relay carried,
  the shared encoder encodes once per relay frame, and ``bye`` returns
  the relay's clients to 0.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu_torch.media import jpeg
from evam_tpu_torch.publish.rtc import rtcp, vp8
from evam_tpu_torch.publish.rtc import ws as wslib
from evam_tpu_torch.publish.rtc.session import RtcSession
from evam_tpu_torch.publish.rtc.signaling import SignalingServer
from evam_tpu_torch.publish.rtc.viewer import Viewer
from evam_tpu_torch.publish.rtsp import FrameRelay
from evam_tpu_torch.publish.webrtc import WebRtcSignaler

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
#: the port modules the blocked-import subprocess must never load
BLOCKED = ("cv2", "cryptography", "websockets")


def _ref_modules() -> types.SimpleNamespace:
    """The reference's media plane (imported here only: the blocked
    subprocess imports this file too)."""
    pytest.importorskip("cryptography")
    from evam_tpu.publish.rtc import dtls, rtcp as r, session, srtp, stun
    from evam_tpu.publish.rtc import vp8 as v

    return types.SimpleNamespace(dtls=dtls, rtcp=r, session=session,
                                 srtp=srtp, stun=stun, vp8=v)


def _green_box(h=360, w=640):
    f = np.zeros((h, w, 3), np.uint8)
    f[h * 100 // 360:h * 260 // 360, w * 200 // 640:w * 440 // 640] = (0, 255, 0)
    return f


def _until(pred, timeout: float, step=None, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        if step is not None:
            step()
        else:
            time.sleep(0.02)


def _session(tmp_path, frame_source=None, **kw) -> RtcSession:
    return RtcSession(frame_source, bind_ip="127.0.0.1",
                      advertise_ip="127.0.0.1", cert_dir=str(tmp_path / "s"),
                      **kw)


def _connected(tmp_path, sess, modules=None) -> Viewer:
    viewer = Viewer(tmp_path / "viewer", modules)
    viewer.accept(sess.answer(viewer.offer))
    sess.start()
    viewer.connect()
    return viewer


# -------------------------------------------------------------- sessions


def test_reference_viewer_decodes_the_port_sessions_video(tmp_path):
    """test_rtc.py's ``test_viewer_receives_decodable_video`` with the
    reference's viewer against the port's session, and the frame decoded:
    the payload is the port encoder's keyframe of the frame, and libvpx
    gives that encoder's reconstruction."""
    from test_torch_rtc import Vp8Decoder

    frame = _green_box()
    sess = _session(tmp_path, lambda: frame, width=320, height=180, fps=30.0)
    viewer = Viewer(tmp_path / "viewer", _ref_modules())
    answer = sess.answer(viewer.offer)
    assert "a=ice-lite" in answer and "a=setup:passive" in answer
    assert f"a=rtcp-fb:{96} nack pli" in answer
    viewer.accept(answer)
    assert viewer.ans["pwd"] == sess.ice.local_pwd
    sess.start()
    try:
        viewer.connect()
        _until(lambda: viewer.frames(), 20, viewer.poll, "a whole frame")
        assert sess.connected.is_set()
        _, payload = viewer.frames()[0]
        assert viewer.rejected == 0
        info = vp8.parse_vp8_header(payload)
        assert info["keyframe"] and info["sync_ok"]
        assert (info["width"], info["height"]) == (320, 180)
        enc = vp8.Vp8Encoder(320, 180)
        assert payload == enc.encode(frame)
        dec = Vp8Decoder()
        for got, want in zip(dec.decode(payload), enc.reconstruction()):
            np.testing.assert_array_equal(got, want)
        dec.close()
    finally:
        viewer.close()
        sess.stop()
    assert sess.frames_sent >= 1


def test_port_viewer_receives_the_reference_sessions_video(tmp_path):
    """The other way round: the port's viewer (its DTLS client, SRTP
    and depacketizer) against the reference's session and encoder."""
    from evam_tpu.publish.rtc.session import RtcSession as RefSession

    frame = _green_box()
    sess = RefSession(lambda: frame, width=320, height=180,
                      bind_ip="127.0.0.1", advertise_ip="127.0.0.1",
                      cert_dir=str(tmp_path / "s"), fps=30.0)
    viewer = _connected(tmp_path, sess)
    try:
        _until(lambda: viewer.frames(), 20, viewer.poll, "a whole frame")
        _, payload = viewer.frames()[0]
        assert viewer.rejected == 0
        info = vp8.parse_vp8_header(payload)
        assert info["keyframe"] and (info["width"], info["height"]) == (320, 180)
    finally:
        viewer.close()
        sess.stop()


def test_nack_retransmit_and_pli_keyframe_in_delta_mode(tmp_path):
    """TestLossRecovery's script against the port's session (delta
    mode, one natural keyframe per 100 frames): a NACKed packet comes
    back as the identical protected packet, a PLI forces a keyframe,
    and heavy RR loss forces one too."""
    state = {"i": 0}

    def frame_source():
        f = np.zeros((180, 320, 3), np.uint8)
        x = (state["i"] * 7) % 280
        f[40:140, x:x + 40] = (0, 255, 0)
        state["i"] += 1
        return f

    sess = _session(tmp_path, frame_source, width=320, height=180, fps=30.0,
                    video_mode="delta", gop=100)
    viewer = _connected(tmp_path, sess, _ref_modules())
    try:
        _until(lambda: viewer.media, 30, viewer.poll, "media")
        viewer.recv_for(2.0)
        frames = viewer.frames()
        flags = [vp8.parse_vp8_header(p)["keyframe"] for _, p in frames]
        assert flags[0] and not any(flags[1:]) and len(flags) > 1

        # NACK: the same bytes on the wire again
        lost = viewer.media[len(viewer.media) // 2]
        lost_seq = int.from_bytes(lost[2:4], "big")
        viewer_ssrc = 0xDEADBEEF
        viewer.send_feedback(rtcp.generic_nack(viewer_ssrc, sess.ssrc,
                                               [lost_seq]))
        _until(lambda: viewer.media.count(lost) > 1, 5, viewer.poll,
               "the retransmission")
        assert sess.nacks_received == 1
        _until(lambda: sess.packets_retransmitted >= 1, 2)

        # PLI: a keyframe next
        keys_before = sum(vp8.parse_vp8_header(p)["keyframe"]
                          for _, p in viewer.frames())
        viewer.send_feedback(rtcp.pli(viewer_ssrc, sess.ssrc))
        _until(lambda: sum(vp8.parse_vp8_header(p)["keyframe"]
                           for _, p in viewer.frames()) > keys_before,
               10, lambda: viewer.recv_for(0.1), "a keyframe after the PLI")
        assert sess.plis_received >= 1 and sess.keyframes_forced >= 1

        # heavy RR loss refreshes the picture too
        forced = sess.keyframes_forced
        viewer.send_feedback(rtcp.receiver_report(
            viewer_ssrc, sess.ssrc, fraction_lost=0.5, cumulative_lost=10,
            highest_seq=max(viewer.seqs())))
        _until(lambda: sess.keyframes_forced > forced, 5, viewer.poll,
               "a keyframe after heavy loss")
    finally:
        viewer.close()
        sess.stop()


def test_rr_loss_adapts_the_frame_rate_and_rtt_surfaces(tmp_path):
    sess = _session(tmp_path, lambda: np.zeros((96, 128, 3), np.uint8),
                    width=128, height=96, fps=30.0)
    viewer = _connected(tmp_path, sess, _ref_modules())
    try:
        _until(lambda: viewer.media, 15, viewer.poll, "media")
        highest = max(viewer.seqs())
        # an RR echoing LSR 50 ms ago and a 20 ms hold: RTT ≈ 30 ms
        lsr = (rtcp.ntp_mid32() - int(0.05 * 65536)) & 0xFFFFFFFF
        viewer.send_feedback(rtcp.receiver_report(
            0xDEADBEEF, sess.ssrc, 0.0, 0, highest, jitter=900, lsr=lsr,
            dlsr=int(0.02 * 65536)))
        _until(lambda: sess.last_rtt_ms is not None, 5, viewer.poll, "RTT")
        assert 5 < sess.last_rtt_ms < 500
        assert sess.last_jitter_ms == 10.0
        assert sess.fps_scale == 1.0
        for k in range(6):
            viewer.send_feedback(rtcp.receiver_report(
                0xDEADBEEF, sess.ssrc, 0.5, 10 * (k + 1), highest))
            viewer.recv_for(0.3)
            if sess.fps_scale <= 0.25:
                break
        assert sess.fps_scale < 1.0 and sess.rate_adaptations >= 1
        low = sess.fps_scale
        for _ in range(10):
            viewer.send_feedback(rtcp.receiver_report(
                0xDEADBEEF, sess.ssrc, 0.0, 60, highest))
            viewer.recv_for(0.2)
            if sess.fps_scale >= 1.0:
                break
        assert sess.fps_scale > low
    finally:
        viewer.close()
        sess.stop()


def test_wrong_dtls_fingerprint_kills_the_session(tmp_path):
    """A DTLS peer whose certificate is not the offer's pin never gets
    SRTP keys: no media, on_dead fires."""
    dead = []
    frame = np.zeros((90, 160, 3), np.uint8)
    sess = _session(tmp_path, lambda: frame, width=160, height=90, fps=30.0,
                    on_dead=dead.append)
    viewer = Viewer(tmp_path / "viewer", _ref_modules())
    viewer.accept(sess.answer(viewer.offer.replace(
        viewer.fingerprint, "00:" * 31 + "00")))
    sess.start()
    try:
        try:
            viewer.connect(timeout=10)
        except TimeoutError:
            pass  # whether or not the client saw Finished
        _until(lambda: dead, 10, what="on_dead")
        assert dead == [sess]
        assert not sess.connected.is_set() and sess.frames_sent == 0
    finally:
        viewer.close()
        sess.stop()


def test_unreached_session_fires_on_dead_once(tmp_path):
    dead = []
    sess = _session(tmp_path, lambda: None, width=160, height=96,
                    connect_timeout_s=1.0, on_dead=dead.append)
    sess.start()
    _until(lambda: dead, 10, what="on_dead")
    sess.stop()
    time.sleep(0.3)
    assert dead == [sess] and not sess.connected.is_set()


def test_session_without_cert_dir_leaves_no_files(tmp_path, monkeypatch):
    """The signaler's sessions have no ``cert_dir``: each makes its key
    in a temporary directory that is gone once DTLS has read it, and
    its viewer still completes the handshake and gets media."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    frame = _green_box(96, 128)
    sess = RtcSession(lambda: frame, width=128, height=96,
                      bind_ip="127.0.0.1", advertise_ip="127.0.0.1", fps=30.0)
    assert list((tmp_path / "tmp").iterdir()) == []
    viewer = _connected(tmp_path, sess)
    try:
        _until(lambda: viewer.frames(), 20, viewer.poll, "a whole frame")
        assert viewer.rejected == 0
    finally:
        viewer.close()
        sess.stop()


def test_session_refuses_what_the_reference_refuses(tmp_path):
    with pytest.raises(ValueError, match="exactly one"):
        _session(tmp_path)
    with pytest.raises(ValueError, match="video_mode"):
        _session(tmp_path, lambda: None, video_mode="gop")
    with pytest.raises(ValueError, match="delta mode"):
        RtcSession(payload_source=lambda: None, video_mode="delta",
                   cert_dir=str(tmp_path / "s"))


# ------------------------------------------------------------ signalling


def _start_signaling(cmd: list[str]):
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline()
    m = re.search(r"ws://[\d.]+:(\d+)", line)
    assert m, f"no port line: {line!r}"
    return proc, f"ws://127.0.0.1:{m.group(1)}"


def test_reference_relay_scenario_against_the_port_module():
    """TestSignalingRelay, with websockets clients, against ``python -m
    evam_tpu_torch.publish.rtc.signaling``; then the viewer leaves and
    the service hears ``bye`` for its peer."""
    websockets = pytest.importorskip("websockets")
    proc, url = _start_signaling([sys.executable, "-m",
                                  "evam_tpu_torch.publish.rtc.signaling",
                                  "--host", "127.0.0.1", "--port", "0"])

    async def run():
        async with websockets.connect(url) as svc:
            async with websockets.connect(url) as viewer:
                await svc.send(json.dumps({"type": "register",
                                           "stream": "cam0"}))
                await asyncio.sleep(0.2)
                await viewer.send(json.dumps({"type": "watch",
                                              "stream": "cam0",
                                              "sdp": "v=0-offer"}))
                offer = json.loads(await asyncio.wait_for(svc.recv(), 10))
                assert offer == {"type": "offer", "stream": "cam0",
                                 "peer": offer["peer"], "sdp": "v=0-offer"}
                await svc.send(json.dumps({"type": "answer", "stream": "cam0",
                                           "peer": offer["peer"],
                                           "sdp": "v=0-answer"}))
                ans = json.loads(await asyncio.wait_for(viewer.recv(), 10))
                assert ans == {"type": "answer", "sdp": "v=0-answer"}
                await viewer.send(b"\xff\xd8binary-is-not-relayed")
                await viewer.send(json.dumps({"type": "watch",
                                              "stream": "nope", "sdp": "x"}))
                err = json.loads(await asyncio.wait_for(viewer.recv(), 10))
                assert err == {"type": "error",
                               "message": "no such stream nope"}
            # a viewer that leaves while watching cam0: bye for its peer
            async with websockets.connect(url) as viewer2:
                await viewer2.send(json.dumps({"type": "watch",
                                               "stream": "cam0", "sdp": "o2"}))
                offer2 = json.loads(await asyncio.wait_for(svc.recv(), 10))
                assert offer2["sdp"] == "o2" and offer2["peer"] != offer["peer"]
            bye = json.loads(await asyncio.wait_for(svc.recv(), 10))
            assert bye == {"type": "bye", "stream": "cam0",
                           "peer": offer2["peer"]}

    try:
        asyncio.run(run())
    finally:
        proc.terminate()
        assert proc.wait(10) == 0


def test_port_ws_client_against_the_reference_relay():
    """The port's websocket client through ``tools/signaling_server.py``
    (websockets' server): register, watch → offer, answer → viewer,
    the error for an unknown stream, and ``bye`` when the viewer goes."""
    pytest.importorskip("websockets")
    proc, url = _start_signaling([sys.executable, "tools/signaling_server.py",
                                  "--host", "127.0.0.1", "--port", "0"])
    try:
        svc = wslib.connect(url)
        viewer = wslib.connect(url)
        svc.send(json.dumps({"type": "register", "stream": "cam0"}))
        time.sleep(0.2)
        viewer.send(json.dumps({"type": "watch", "stream": "cam0",
                                "sdp": "v=0-offer"}))
        offer = json.loads(svc.recv(10))
        assert (offer["type"], offer["sdp"], offer["stream"]) == \
            ("offer", "v=0-offer", "cam0")
        svc.send(json.dumps({"type": "answer", "stream": "cam0",
                             "peer": offer["peer"], "sdp": "A" * 70000}))
        assert json.loads(viewer.recv(10)) == {"type": "answer",
                                               "sdp": "A" * 70000}
        viewer.send(json.dumps({"type": "watch", "stream": "nope",
                                "sdp": "x"}))
        assert json.loads(viewer.recv(10))["type"] == "error"
        assert svc.recv(0.2) is None  # nothing else for the service
        viewer.close()
        viewer2 = wslib.connect(url)
        viewer2.send(json.dumps({"type": "watch", "stream": "cam0",
                                 "sdp": "o2"}))
        offer2 = json.loads(svc.recv(10))
        viewer2.close()
        assert json.loads(svc.recv(10)) == {"type": "bye", "stream": "cam0",
                                            "peer": offer2["peer"]}
        svc.close()
    finally:
        proc.terminate()
        proc.wait(10)


def test_port_relay_carries_the_mjpeg_fallback():
    """The port relay's one addition: a viewer's ``play`` reaches the
    service (the port's signaler) once for its first player, its JPEGs
    come back to every player, and ``stop`` after the last player (or a
    player's disconnect) reaches the service, whose relay client goes."""
    srv = SignalingServer("127.0.0.1", 0).start()
    url = f"ws://127.0.0.1:{srv.port}"
    relay = FrameRelay("cam0")
    stop = threading.Event()
    _pusher(relay, stop)
    sig = WebRtcSignaler(url, "cam0", relay)
    sig.start()
    players = []
    try:
        _until(lambda: "cam0" in srv.services, 15, what="registration")
        players = [wslib.connect(url) for _ in range(2)]
        for p in players:
            p.send(json.dumps({"type": "play", "stream": "cam0"}))
        for p in players:
            blob = p.recv(15)
            assert isinstance(blob, bytes)
            assert jpeg.decode(blob).shape == (176, 320, 3)
        assert relay._clients == 1  # one play for both players
        players[0].send(json.dumps({"type": "stop", "stream": "cam0"}))
        assert isinstance(players[1].recv(15), bytes)
        assert relay._clients == 1
        players[1].close()  # the last player leaves: stop
        _until(lambda: relay._clients == 0, 15, what="stop's release")
    finally:
        for p in players:
            p.close()
        stop.set()
        sig.stop()
        srv.stop()


def test_ws_client_and_server_interoperate_with_websockets(tmp_path):
    """Frames both ways with ``websockets``: the port's server takes a
    fragmented message, a ping and binary from websockets' client; the
    port's client takes websockets' server's fragments, ping and close
    code; a large message crosses the 16- and 64-bit length forms."""
    websockets = pytest.importorskip("websockets")
    seen = []

    def echo(ws):
        while True:
            msg = ws.recv()
            seen.append(msg)
            ws.send(msg)

    server = wslib.WsServer("127.0.0.1", 0, echo).start()
    big = bytes(range(256)) * 300

    async def client():
        async with websockets.connect(f"ws://127.0.0.1:{server.port}") as ws:
            await ws.send(["frag", "mented", " text"])
            assert await ws.recv() == "fragmented text"
            pong = await ws.ping(b"hello")
            await asyncio.wait_for(pong, 5)
            await ws.send(big)
            assert await ws.recv() == big
            await ws.send("x" * 200)
            assert await ws.recv() == "x" * 200

    try:
        asyncio.run(client())
        assert seen == ["fragmented text", big, "x" * 200]
    finally:
        server.stop()

    async def serve():
        async def handler(ws):
            await ws.send(["part1-", "part2"])
            await ws.ping(b"p")
            await ws.send(big)
            msg = await ws.recv()
            await ws.send(msg)
            await ws.close(4000, "bye now")

        async with websockets.serve(handler, "127.0.0.1", 0) as srv:
            port = srv.sockets[0].getsockname()[1]

            def port_client():
                c = wslib.connect(f"ws://127.0.0.1:{port}")
                assert c.recv(10) == "part1-part2"
                assert c.recv(10) == big  # the ping was answered on the way
                c.send("from the port")
                assert c.recv(10) == "from the port"
                with pytest.raises(wslib.ConnectionClosed) as info:
                    c.recv(10)
                assert info.value.code == 4000
                return True

            assert await asyncio.to_thread(port_client)

    asyncio.run(serve())


def test_ws_client_speaks_wss(tmp_path, monkeypatch):
    """``wss://`` (the reference's ``websockets.connect`` takes it) goes
    through the standard library's TLS: the port's client against
    websockets' server on a self-signed certificate (trusted here by
    the test alone), a message each way."""
    import ssl

    websockets = pytest.importorskip("websockets")
    from evam_tpu_torch.publish.rtc import dtls

    cert, key, _ = dtls.generate_certificate(str(tmp_path))
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(cert, key)
    client_ctx = ssl.create_default_context(cafile=cert)
    client_ctx.check_hostname = False  # the certificate names evam-tpu
    monkeypatch.setattr(wslib.ssl, "create_default_context",
                        lambda: client_ctx)

    async def serve():
        async def handler(ws):
            await ws.send("over tls " + await ws.recv())

        async with websockets.serve(handler, "127.0.0.1", 0,
                                    ssl=server_ctx) as srv:
            port = srv.sockets[0].getsockname()[1]

            def port_client():
                c = wslib.connect(f"wss://127.0.0.1:{port}/path")
                c.send("hello")
                got = c.recv(10)
                c.close()
                return got

            assert await asyncio.to_thread(port_client) == "over tls hello"

    asyncio.run(serve())


def test_ws_server_refuses_a_plain_http_request():
    server = wslib.WsServer("127.0.0.1", 0, lambda ws: None).start()
    try:
        import urllib.error
        import urllib.request

        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(f"http://127.0.0.1:{server.port}/",
                                   timeout=10)
        assert info.value.code == 400
        with pytest.raises(ValueError, match="ws://"):
            wslib.connect("http://127.0.0.1:1/")
    finally:
        server.stop()


# -------------------------------------------------------------- signaler


class _ScriptedRelayServer:
    """A signalling server the test drives: the one service connection,
    its messages in a queue, ``send`` to it."""

    def __init__(self):
        import queue

        self.inbox: "queue.Queue" = queue.Queue()
        self.conns: list = []
        self.server = wslib.WsServer("127.0.0.1", 0, self._handle).start()
        self.url = f"ws://127.0.0.1:{self.server.port}"

    def _handle(self, ws):
        self.conns.append(ws)
        while True:
            self.inbox.put(ws.recv())

    def next(self, timeout=15.0, text=True):
        deadline = time.monotonic() + timeout
        while True:
            msg = self.inbox.get(timeout=max(0.01, deadline - time.monotonic()))
            if isinstance(msg, str) == text:
                return json.loads(msg) if text else msg

    def send(self, obj) -> None:
        self.conns[-1].send(json.dumps(obj))

    def stop(self):
        self.server.stop()


def _signaler(kind: str, url: str, relay):
    if kind == "reference":
        pytest.importorskip("websockets")
        from evam_tpu.publish.webrtc import WebRtcSignaler as RefSignaler

        return RefSignaler(url, "cam0", relay)
    return WebRtcSignaler(url, "cam0", relay)


def _pusher(relay, stop: threading.Event):
    frame = _green_box(180, 320)

    def run():
        i = 0
        while not stop.is_set():
            if relay.has_clients:
                f = frame.copy()
                f[:, i % 320] = 255
                relay.push_bgr(f)
                i += 1
            time.sleep(1 / 30)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("kind", ["port", "reference"])
def test_signaler_answers_plays_and_releases_the_relay(tmp_path, kind):
    """The same script against the port's and the reference's
    signaler: register; offer → an ice-lite, passive, nack/pli answer
    and one relay client; ``bye`` → 0; ``play`` → binary JPEGs the
    port's codec decodes and one client; ``stop`` → 0; a second offer,
    then ``stop()`` → 0."""
    srv = _ScriptedRelayServer()
    relay = FrameRelay("cam0")
    stop = threading.Event()
    _pusher(relay, stop)
    sig = _signaler(kind, srv.url, relay)
    sig.start()
    try:
        assert srv.next() == {"type": "register", "stream": "cam0"}
        viewer = Viewer(tmp_path / "v")
        srv.send({"type": "offer", "stream": "cam0", "peer": "7",
                  "sdp": viewer.offer})
        answer = srv.next()
        assert (answer["type"], answer["peer"], answer["stream"]) == \
            ("answer", "7", "cam0")
        for line in ("a=ice-lite", "a=setup:passive", "a=rtcp-mux",
                     "a=rtcp-fb:96 nack pli", "a=rtcp-fb:96 ccm fir",
                     "a=sendonly", "VP8/90000"):
            assert line in answer["sdp"]
        assert relay._clients == 1
        srv.send({"type": "bye", "stream": "cam0", "peer": "7"})
        _until(lambda: relay._clients == 0, 10, what="bye's release")
        # other streams' messages are not ours
        srv.send({"type": "play", "stream": "other"})
        srv.send({"type": "play", "stream": "cam0"})
        blobs = [srv.next(text=False) for _ in range(3)]
        assert relay._clients == 1
        for blob in blobs:  # the relay rounds sizes to whole 8×8 blocks
            assert jpeg.decode(blob).shape == (176, 320, 3)
        srv.send({"type": "stop", "stream": "cam0"})
        _until(lambda: relay._clients == 0, 10, what="stop's release")
        srv.send({"type": "offer", "stream": "cam0", "peer": "8",
                  "sdp": viewer.offer})
        assert srv.next()["peer"] == "8"
        assert relay._clients == 1
        viewer.close()
    finally:
        sig.stop()
        stop.set()
        srv.stop()
    _until(lambda: relay._clients == 0, 10, what="stop()'s release")


def test_signaler_reconnects_and_registers_again(tmp_path, caplog):
    """A lost connection releases a play's client and is reopened after
    the 1 s back-off; the stream registers again."""
    srv = _ScriptedRelayServer()
    relay = FrameRelay("cam0")
    sig = WebRtcSignaler(srv.url, "cam0", relay)
    caplog.set_level(logging.WARNING, "evam_tpu_torch.publish.webrtc")
    sig.start()
    try:
        assert srv.next()["type"] == "register"
        srv.send({"type": "play", "stream": "cam0"})
        _until(lambda: relay._clients == 1, 10, what="play")
        t0 = time.monotonic()
        srv.conns[-1].close()
        assert srv.next()["type"] == "register"
        assert time.monotonic() - t0 >= 0.9  # the back-off
        assert relay._clients == 0
        assert "retry in 1s" in caplog.text
    finally:
        sig.stop()
        srv.stop()


def test_failed_answer_is_logged_and_the_loop_lives_on(tmp_path, caplog,
                                                       monkeypatch):
    from evam_tpu_torch.publish.rtc import session

    srv = _ScriptedRelayServer()
    relay = FrameRelay("cam0")
    sig = WebRtcSignaler(srv.url, "cam0", relay)
    caplog.set_level(logging.WARNING, "evam_tpu_torch.publish.webrtc")

    def broken(*_a, **_k):
        raise RuntimeError("webrtc: libcrypto not found")

    viewer = Viewer(tmp_path / "v")
    monkeypatch.setattr(session.dtls, "generate_certificate", broken)
    sig.start()
    try:
        assert srv.next()["type"] == "register"
        srv.send({"type": "offer", "stream": "cam0", "peer": "1",
                  "sdp": viewer.offer})
        _until(lambda: "offer handling failed" in caplog.text, 10,
               what="the warning")
        assert "libcrypto" in caplog.text
        assert relay._clients == 0 and sig.sessions == {}
        monkeypatch.undo()
        srv.send({"type": "offer", "stream": "cam0", "peer": "2",
                  "sdp": viewer.offer})
        assert srv.next()["peer"] == "2"
        viewer.close()
    finally:
        sig.stop()
        srv.stop()


# ------------------------------------------------- the whole path, blocked


def _whole_path(tmp: str) -> dict:
    """The port's signalling server, signaler and sessions with two
    key-mode viewers (the port's primitives in the client role) joining
    through the relay by websocket. Returns what it saw."""
    tmp = Path(tmp)
    srv = SignalingServer("127.0.0.1", 0).start()
    url = f"ws://127.0.0.1:{srv.port}"
    relay = FrameRelay("cam0")
    pushed: list[bytes] = []
    push_jpeg = relay.push_jpeg

    def record(blob):
        pushed.append(blob)
        push_jpeg(blob)

    relay.push_jpeg = record
    stop = threading.Event()
    _pusher(relay, stop)
    sig = WebRtcSignaler(url, "cam0", relay)
    sig.start()
    viewers, conns = [], []
    try:
        _until(lambda: "cam0" in srv.services, 15, what="registration")
        for i in range(2):
            v = Viewer(tmp / f"v{i}")
            c = wslib.connect(url)
            c.send(json.dumps({"type": "watch", "stream": "cam0",
                               "sdp": v.offer}))
            answer = json.loads(c.recv(30))
            assert answer["type"] == "answer", answer
            v.accept(answer["sdp"])
            v.connect()
            viewers.append(v)
            conns.append(c)
        for v in viewers:
            _until(lambda v=v: len(v.frames()) >= 3, 30, v.poll, "3 frames")
        got = [[p for _, p in v.frames()] for v in viewers]
        assert all(v.rejected == 0 for v in viewers)
        assert relay._clients == 2
        encodes = sig._vp8.encodes
        for c in conns:
            c.close()
        _until(lambda: relay._clients == 0, 15, what="bye's release")
    finally:
        stop.set()
        sig.stop()
        srv.stop()
        for v in viewers:
            v.close()
    enc = vp8.Vp8Encoder(640, 360)
    encoded = {enc.encode(jpeg.decode(b)) for b in pushed}
    return {"frames": [len(g) for g in got],
            "keyframes": all(vp8.parse_vp8_header(p)["keyframe"]
                             for g in got for p in g),
            "all_reencoded": all(p in encoded for g in got for p in g),
            "encodes": encodes, "pushed": len(pushed),
            "sizes": sorted({(vp8.parse_vp8_header(p)["width"],
                              vp8.parse_vp8_header(p)["height"])
                             for g in got for p in g})}


def test_whole_path_runs_with_cv2_cryptography_and_websockets_blocked(
        tmp_path):
    code = "\n".join([
        "import json, sys",
        *[f"sys.modules[{b!r}] = None" for b in BLOCKED],
        f"sys.path.insert(0, {str(REPO / 'tests')!r})",
        "import test_torch_webrtc as t",
        f"out = t._whole_path({str(tmp_path)!r})",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None)",
        "assert not bad, bad",
        "print(json.dumps(out))",
    ])
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert min(out["frames"]) >= 3 and out["keyframes"]
    assert out["all_reencoded"], out
    assert out["sizes"] == [[640, 360]]
    # one encode per relay frame, shared by both viewers
    assert 0 < out["encodes"] <= out["pushed"]
