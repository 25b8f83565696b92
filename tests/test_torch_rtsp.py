"""The port's RTSP server and demux against the reference's, both ways,
over TCP on 127.0.0.1.

* The port's ``RtspDemux`` reads the reference's ``RtspServer`` and the
  reference's demux reads the port's, on JPEG and H.264 mounts: each
  decoded frame equals what the reference's path makes of the same
  bytes (``cv2.imdecode`` for JPEG, ``decode_ipcm_au`` for I_PCM).
* ``FrameRelay.push_bgr`` sends the bytes the reference's sends.
* Drop-oldest counts, ``stats()``, end of stream and the error paths
  (an unknown mount, a codec the demux does not speak) agree.
* ``RtspSource``, the per-stream blocking reader: frames, a clean end
  when the server closes, ``IOError`` for a missing mount.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from evam_tpu.media import h264 as ref_h264  # noqa: E402
from evam_tpu.media.demux import RtspDemux as RefDemux  # noqa: E402
from evam_tpu.publish.rtsp import FrameRelay as RefRelay  # noqa: E402
from evam_tpu.publish.rtsp import RtspServer as RefServer  # noqa: E402
from evam_tpu_torch.media.demux import RtspDemux, RtspSource  # noqa: E402
from evam_tpu_torch.publish.rtsp import FrameRelay, RtspServer  # noqa: E402

torch.set_num_threads(1)

SERVERS = {"port": RtspServer, "ref": RefServer}
DEMUXES = {"port": RtspDemux, "ref": RefDemux}


def _frame(h: int = 48, w: int = 64, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = np.zeros((h, w, 3), np.uint8)
    f[:, :, 1] = np.arange(w, dtype=np.uint8)[None] * 3
    f[8:24, 16:40] = rng.integers(0, 256, 3)
    return f


def _payloads() -> dict[str, tuple[bytes, np.ndarray]]:
    """codec → (the bytes a camera sends, the reference path's frame)."""
    blob = cv2.imencode(".jpg", _frame(), [cv2.IMWRITE_JPEG_QUALITY, 80])[1]
    blob = blob.tobytes()
    au = ref_h264.encode_frames([_frame(seed=1)])
    return {"jpeg": (blob, cv2.imdecode(np.frombuffer(blob, np.uint8),
                                        cv2.IMREAD_COLOR)),
            "h264": (au, ref_h264.decode_ipcm_au(au))}


class _Camera:
    """A server with one mount per codec, each pushed its bytes at 60 fps
    until stopped."""

    def __init__(self, server_cls, payloads):
        self.srv = server_cls(port=0, host="127.0.0.1")
        self.srv.start()
        self.stop_ev = threading.Event()
        for codec, (blob, _) in payloads.items():
            relay = self.srv.mount(codec, codec=codec)
            threading.Thread(target=self._feed, args=(relay, blob),
                             daemon=True).start()

    def _feed(self, relay, blob):
        while not self.stop_ev.is_set():
            relay.push_jpeg(blob)
            time.sleep(1 / 60)

    def url(self, path: str) -> str:
        return f"rtsp://127.0.0.1:{self.srv.port}/{path}"

    def close(self):
        self.stop_ev.set()
        self.srv.stop()


@pytest.fixture
def payloads():
    return _payloads()


@pytest.mark.parametrize("codec", ["jpeg", "h264"])
@pytest.mark.parametrize("server,demux", [("ref", "port"), ("port", "ref"),
                                          ("port", "port")])
def test_demux_reads_the_other_packages_server(server, demux, codec, payloads):
    cam = _Camera(SERVERS[server], payloads)
    dm = DEMUXES[demux](decode_workers=2)
    try:
        stream = dm.add_stream(cam.url(codec), stream_id="s")
        seqs = []
        for ev in stream.frames():
            np.testing.assert_array_equal(ev.frame, payloads[codec][1])
            seqs.append(ev.seq)
            if len(seqs) == 4:
                break
        assert seqs == [1, 2, 3, 4]
        stats = dm.stats()
        assert stats["streams"] == 1 and stats["threads"] == 3
        assert stats["decoded"] >= 4
        stream.close()
    finally:
        dm.stop()
        cam.close()


@pytest.mark.parametrize("demux", ["port", "ref"])
def test_stats_drops_and_end_of_stream_agree(demux, payloads):
    """A consumer that reads nothing: the bounded queue keeps the newest
    frames and counts the rest as downstream drops; the server's close
    ends the stream with the error ``rtsp EOF``; stats() keeps the
    retired stream's counters."""
    cam = _Camera(RtspServer, payloads)
    dm = DEMUXES[demux](decode_workers=1)
    try:
        stream = dm.add_stream(cam.url("jpeg"), maxsize=2)
        deadline = time.time() + 30
        while stream.frames_dropped_downstream < 3:
            assert time.time() < deadline, dm.stats()
            time.sleep(0.02)
        cam.close()
        deadline = time.time() + 30
        while not stream.finished:
            assert time.time() < deadline
            time.sleep(0.02)
        assert stream.error == "rtsp EOF"
        frames = list(stream.frames())
        assert len(frames) <= 2
        stats = dm.stats()
        # the port adds its decode workers' seconds, by codec
        decode_s = stats.pop("decode_s") if demux == "port" else None
        assert set(stats) == {"streams", "threads", "decoded", "dropped",
                              "dropped_decode", "dropped_downstream"}
        if demux == "port":
            assert decode_s["jpeg"] > 0 and decode_s["h264"] == 0
        assert stats["streams"] == 0 and stats["threads"] == 2
        assert stats["dropped"] == (stats["dropped_decode"]
                                    + stats["dropped_downstream"])
        assert stats["decoded"] == stream.frames_decoded >= 3
    finally:
        dm.stop()
        cam.close()


def _serve_sdp(sdp: str) -> tuple[socket.socket, int]:
    """An RTSP server that answers DESCRIBE with ``sdp`` and every other
    request with a bare 200."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)

    def serve(conn):
        data = b""
        with conn:
            while True:
                while b"\r\n\r\n" not in data:
                    chunk = conn.recv(4096)
                    if not chunk:
                        return
                    data += chunk
                head, _, data = data.partition(b"\r\n\r\n")
                body = sdp.encode() if head.startswith(b"DESCRIBE") else b""
                conn.sendall(b"RTSP/1.0 200 OK\r\nCSeq: 1\r\nSession: 1\r\n"
                             b"Content-Length: " + str(len(body)).encode()
                             + b"\r\n\r\n" + body)

    def run():
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            threading.Thread(target=serve, args=(conn,), daemon=True).start()

    threading.Thread(target=run, daemon=True).start()
    return lsock, lsock.getsockname()[1]


@pytest.mark.parametrize("demux", ["port", "ref"])
def test_error_paths_agree(demux, payloads):
    cam = _Camera(RtspServer, payloads)
    lsock, sdp_port = _serve_sdp(
        "v=0\r\nm=video 0 RTP/AVP 98\r\na=rtpmap:98 VP8/90000\r\n")
    messages = {}
    try:
        for name in DEMUXES:
            dm = DEMUXES[name](decode_workers=1)
            try:
                with pytest.raises(IOError) as missing:
                    dm.add_stream(cam.url("nope"))
                with pytest.raises(IOError) as vp8:
                    dm.add_stream(f"rtsp://127.0.0.1:{sdp_port}/x")
                messages[name] = (str(missing.value), str(vp8.value))
            finally:
                dm.stop()
            with pytest.raises(RuntimeError, match="stopped"):
                dm.add_stream(cam.url("jpeg"))
    finally:
        lsock.close()
        cam.close()
    assert messages["port"] == messages["ref"]
    assert "404" in messages[demux][0] and "payload type 98" in messages[demux][1]


def test_push_bgr_sends_the_references_bytes():
    ours, ref = FrameRelay("a"), RefRelay("a")
    # sizes on the 8-pixel grid RFC 2435 carries go out unresized
    for h, w in ((48, 64), (40, 56)):
        f = _frame(h, w, seed=h)
        for quality in (80, 50):
            ours.push_bgr(f, quality)
            ref.push_bgr(f, quality)
            assert ours.next_frame(0)[0] == ref.next_frame(0)[0]
    # off the grid, or past RFC 2435's 2040-pixel cap, both resize to
    # the same grid (the port's bilinear resize is the native library's,
    # not cv2's: the sizes agree, the pixels need not)
    for h, w in ((36, 52), (16, 2100)):
        big = _frame(h, w)
        ours.push_bgr(big)
        ref.push_bgr(big)
        decoded = [cv2.imdecode(np.frombuffer(r.next_frame(0)[0], np.uint8),
                                cv2.IMREAD_COLOR) for r in (ours, ref)]
        assert decoded[0].shape == decoded[1].shape == (
            h * min(1.0, 2040 / max(h, w)) // 8 * 8 or 8,
            int(w * min(1.0, 2040 / max(h, w))) // 8 * 8, 3)
    with pytest.raises(ValueError, match="codec"):
        FrameRelay("x", codec="vp8")


def test_mount_rules_equal_the_references():
    for cls in (RtspServer, RefServer):
        srv = cls(port=0, host="127.0.0.1")
        relay = srv.mount("/cam/")
        assert relay.path == "cam" and srv.mount("cam") is relay
        with pytest.raises(ValueError, match="codec"):
            srv.mount("cam", codec="h264")
        srv.unmount("cam")
        assert srv.mount("cam", codec="h264").codec == "h264"


def test_rtsp_source_is_a_blocking_reader(payloads):
    cam = _Camera(RtspServer, payloads)
    try:
        src = RtspSource(cam.url("h264"))
        got = []
        for ev in src.frames():
            got.append(ev)
            if len(got) == 3:
                break
        src.close()
        np.testing.assert_array_equal(got[-1].frame, payloads["h264"][1])
        assert all(ev.decode_s is not None and ev.decode_s >= 0 for ev in got)
        with pytest.raises(IOError, match="404"):
            list(RtspSource(cam.url("nope")).frames())
        # the server closing the stream ends it cleanly
        src = RtspSource(cam.url("jpeg"))
        frames = src.frames()
        next(frames)
        cam.close()
        assert sum(1 for _ in frames) >= 0
    finally:
        cam.close()


# ------------------------------------------------------------ annotation


def test_boxes_are_cv2_rectangles_pixel_for_pixel():
    from evam_tpu_torch.publish.annotate import draw_box

    rng = np.random.default_rng(0)
    for case in range(400):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        x0, y0 = (int(v) for v in rng.integers(-20, 80, 2))
        bw, bh = (int(v) for v in rng.integers(0, 60, 2))
        if case % 5 == 0:
            bw = int(rng.integers(0, 3))  # thin and degenerate boxes
        base = rng.integers(0, 256, (h, w, 3), np.uint8)
        want = base.copy()
        cv2.rectangle(want, (x0, y0), (x0 + bw, y0 + bh), (64, 220, 64), 2)
        got = base.copy()
        draw_box(got, x0, y0, x0 + bw, y0 + bh)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, x0, y0,
                                                               bw, bh)))


def _ctx(frame, regions):
    from evam_tpu_torch.stages.context import FrameContext

    return FrameContext(frame=frame, pts_ns=0, seq=0, stream_id="s",
                        regions=regions)


def _regions(port: bool):
    from evam_tpu.stages import context as ref_context
    from evam_tpu_torch.stages import context

    mod = context if port else ref_context
    attr = [mod.Tensor("color", 0.8, 1, "white"),
            mod.Tensor("type", 0.7, 2, "car"),
            mod.Tensor("extra", 0.6, 0, "third"),
            mod.Tensor("detection", 0.9, 1, "vehicle", is_detection=True)]
    return [mod.Region(0.1, 0.2, 0.5, 0.7, 0.9134, 1, "vehicle",
                       object_id=7, tensors=attr),
            mod.Region(0.6, 0.01, 0.95, 0.3, 0.5, 2, "person"),
            mod.Region(0.9, 0.9, 1.2, 1.3, 0.25, 3, "bike",
                       tensors=attr[:1])]


def test_labels_carry_the_references_string_inside_cv2s_text_box(
        monkeypatch):
    """The reference's label string at its origin; the port's bitmap
    glyphs stay inside the box ``cv2.getTextSize`` gives there, clipped
    to the frame."""
    from evam_tpu.publish import annotate as ref_annotate
    from evam_tpu.stages.context import FrameContext as RefContext
    from evam_tpu_torch.publish.annotate import (
        annotate_frame,
        draw_box,
        label_text,
    )

    frame = np.full((120, 160, 3), 30, np.uint8)
    said = []
    real_put = cv2.putText
    monkeypatch.setattr(cv2, "putText", lambda img, text, org, *a: (
        said.append((text, org)), real_put(img, text, org, *a))[1])
    ref_annotate.annotate_frame(RefContext(
        frame=frame, pts_ns=0, seq=0, stream_id="s",
        regions=_regions(port=False)))
    regions = _regions(port=True)
    assert [label_text(r) for r in regions] == [t for t, _ in said]
    assert said[0][0] == "vehicle #7 white/car 0.91"

    got = annotate_frame(_ctx(frame, regions))
    boxes_only = frame.copy()
    for r in regions:
        x, y, bw, bh = r.rect(160, 120)
        draw_box(boxes_only, x, y, x + bw, y + bh)
    text = np.any(got != boxes_only, axis=-1)
    allowed = np.zeros_like(text)
    for text_str, (ox, oy) in said:
        (tw, th), base = cv2.getTextSize(text_str, cv2.FONT_HERSHEY_SIMPLEX,
                                         0.45, 1)
        allowed[max(oy - th, 0):max(oy + base + 1, 0),
                max(ox, 0):max(ox + tw, 0)] = True
    assert text.any() and not (text & ~allowed).any()
    assert (got[text] == 255).all()


def test_any_label_stays_inside_its_text_box():
    import string

    from evam_tpu_torch.publish.annotate import draw_label

    rng = np.random.default_rng(1)
    chars = list(string.printable[:95])
    for _ in range(300):
        text = "".join(rng.choice(chars, int(rng.integers(1, 30))))
        h, w = (int(v) for v in rng.integers(10, 80, 2))
        ox, oy = int(rng.integers(-10, 60)), int(rng.integers(0, 90))
        frame = np.zeros((h, w, 3), np.uint8)
        draw_label(frame, text, ox, oy)
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                         0.45, 1)
        ys, xs = np.nonzero(frame[..., 0])
        assert ((xs >= ox) & (xs < ox + tw) & (ys >= oy - th)
                & (ys <= oy + base)).all(), text
