"""Slice 11a's ingest on the CPU: sources, the decode worker, the pool,
the demux behind the registry, the RTSP frame destination, and the
whole path with cv2 made unimportable.

* ``FileSource`` on an Annex-B I_PCM ``.h264`` file and an ``.mjpeg``
  file decodes without cv2 to the reference's decode path's frames
  (``decode_ipcm_au`` per access unit, ``cv2.imdecode`` per JPEG), with
  the reference ``FileSource``'s count and timestamps; an access unit
  that is not I_PCM hands the rest of the file to cv2; ``loop`` and
  ``realtime`` behave as in the reference; other files take cv2.
* ``DecodeWorker`` and ``DecodePool`` give the reference's frames and
  counters on the same sources.
* ``webcam`` and ``gige`` sources come over with cv2 (a fake cv2 module
  here: there is no camera) and fail naming cv2 without it.
* Through ``PipelineRegistry``: the shared pool and demux
  (EVAM_DECODE_POOL_WORKERS, EVAM_RTSP_DEMUX_WORKERS), ``/healthz``'s
  blocks for them; the ``rtsp`` frame destination mounts a relay whose
  frames are annotated only while a client watches, unmounts on stop
  and on a failed start, and mounts again on ``resume()``; ``serve``
  with ENABLE_RTSP listens on RTSP_PORT.
* With ``cv2`` blocked in a subprocess (the card's machine in
  miniature), MJPEG and I_PCM cameras, ``.h264`` and ``.mjpeg`` files,
  a ``jpeg``-encoded frame and the annotated re-stream all work, and an
  ``.mp4`` URI fails naming cv2.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from evam_tpu.media import DecodePool as RefPool  # noqa: E402
from evam_tpu.media import DecodeWorker as RefWorker  # noqa: E402
from evam_tpu.media import h264 as ref_h264  # noqa: E402
from evam_tpu.media.source import FileSource as RefFileSource  # noqa: E402
from evam_tpu.media.source import SyntheticSource as RefSynthetic  # noqa: E402
from evam_tpu.media.source import gige_frame_to_bgr as ref_gige  # noqa: E402
from evam_tpu_torch.config.settings import Settings  # noqa: E402
from evam_tpu_torch.engine.hub import EngineHub  # noqa: E402
from evam_tpu_torch.media import DecodePool, DecodeWorker, h264, jpeg  # noqa: E402
from evam_tpu_torch.media.demux import RtspDemux  # noqa: E402
from evam_tpu_torch.media.source import (  # noqa: E402
    FileSource,
    GigeSource,
    SyntheticSource,
    WebcamSource,
    create_source,
    gige_frame_to_bgr,
)
from evam_tpu_torch.models.registry import ModelRegistry  # noqa: E402
from evam_tpu_torch.publish.rtsp import FrameRelay, RtspServer  # noqa: E402
from evam_tpu_torch.server import registry as registry_mod  # noqa: E402
from evam_tpu_torch.server.app import App, make_server  # noqa: E402
from evam_tpu_torch.server.registry import PipelineRegistry  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
KEY = "object_detection/person_vehicle_bike"
PIPE = ("object_detection", "person_vehicle_bike")


def _frames(n: int, h: int = 48, w: int = 64, seed: int = 0) -> list:
    return [ev.frame for ev in SyntheticSource(w, h, count=n,
                                               seed=seed).frames()]


def _write_h264(path: Path, n: int = 5, h: int = 48, w: int = 64) -> list:
    frames = _frames(n, h, w, seed=1)
    h264.write_annexb(str(path), frames)
    return frames


def _write_mjpeg(path: Path, n: int = 5, h: int = 48, w: int = 64) -> list:
    blobs = [jpeg.encode(f, 80) for f in _frames(n, h, w, seed=2)]
    path.write_bytes(b"".join(blobs))
    return blobs


# ------------------------------------------------------------ FileSource


def test_h264_file_decodes_without_cv2_to_the_references_frames(tmp_path):
    path = tmp_path / "cam.h264"
    _write_h264(path, 6, 36, 52)
    data = path.read_bytes()
    nals = ref_h264.split_annexb(data)
    sps, pps, slices = nals[0], nals[1], nals[2:]
    want = [ref_h264.decode_ipcm_au(b"".join(
        b"\x00\x00\x00\x01" + n for n in (sps, pps, s))) for s in slices]
    got = list(FileSource(str(path)).frames())
    ref = list(RefFileSource(str(path)).frames())
    assert len(got) == len(ref) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.frame, w)
    assert [e.pts_ns for e in got] == [e.pts_ns for e in ref]
    assert [e.seq for e in got] == [e.seq for e in ref]
    # cv2's FFmpeg converts with swscale, a level off at most
    for g, r in zip(got, ref):
        assert np.abs(g.frame.astype(int) - r.frame).max() <= 2


def test_mjpeg_file_decodes_without_cv2_to_imdecode(tmp_path):
    path = tmp_path / "cam.mjpeg"
    blobs = _write_mjpeg(path, 5)
    got = list(FileSource("file://" + str(path)).frames())
    ref = list(RefFileSource(str(path)).frames())
    assert len(got) == len(ref) == 5
    for g, b in zip(got, blobs):
        np.testing.assert_array_equal(
            g.frame, cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR))
    assert [e.pts_ns for e in got] == [e.pts_ns for e in ref]


def test_mjpeg_files_split_at_each_images_end(tmp_path):
    """An image with restart markers, and one whose APP1 segment holds a
    whole thumbnail JPEG (its own SOI and EOI), stay whole."""
    frames = _frames(3)
    blobs = [jpeg.encode(f, 80) for f in frames[:2]]
    blobs.append(cv2.imencode(".jpg", frames[2], [
        cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes())
    thumb = jpeg.encode(frames[0][:8, :8], 50)
    app1 = b"\xff\xe1" + (len(thumb) + 2).to_bytes(2, "big") + thumb
    blobs.append(blobs[1][:2] + app1 + blobs[1][2:])
    path = tmp_path / "cam.mjpeg"
    path.write_bytes(b"".join(blobs))
    got = [ev.frame for ev in FileSource(str(path)).frames()]
    assert len(got) == 4
    for g, b in zip(got, blobs):
        np.testing.assert_array_equal(
            g, cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("kind", ["h264", "mjpeg"])
def test_a_long_file_is_read_one_frame_at_a_time(tmp_path, kind):
    """A recording far larger than one frame (here 400 frames) is
    mapped and walked, never read whole or split into a list: the
    Python heap's peak over a whole pass, loop included, stays within a
    few frames' bytes (reading the file whole would peak above its
    size)."""
    import tracemalloc

    path = tmp_path / f"long.{kind}"
    n, h, w = 400, 96, 128
    frame = np.random.default_rng(0).integers(0, 256, (h, w, 3), np.uint8)
    if kind == "h264":
        h264.write_annexb(str(path), [frame] * n)
    else:
        path.write_bytes(jpeg.encode(frame, 95) * n)
    size = path.stat().st_size
    one_frame = h * w * 3
    src = FileSource(str(path), loop=True)
    tracemalloc.start()
    try:
        got = 0
        for _ in src.frames():
            got += 1
            if got == n + 3:
                src.close()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert got == n + 3
    assert size > 160 * one_frame
    assert peak < min(16 * one_frame, size / 8), (peak, size)
    assert src._map is None  # the map is let go at the end


def test_loop_and_realtime_behave_as_the_references(tmp_path):
    path = tmp_path / "cam.mjpeg"
    _write_mjpeg(path, 3)
    src = FileSource(str(path), loop=True)
    it = src.frames()
    seqs = [next(it).seq for _ in range(7)]
    src.close()
    assert seqs == list(range(7))
    t0 = time.perf_counter()
    n = sum(1 for _ in FileSource(str(path), realtime=True).frames())
    assert n == 3 and time.perf_counter() - t0 >= 2 / 25 - 0.01


def test_a_foreign_access_unit_hands_the_rest_to_cv2(tmp_path, monkeypatch):
    path = tmp_path / "cam.h264"
    _write_h264(path, 5)
    ref = list(RefFileSource(str(path)).frames())
    real = h264.decode_ipcm_au
    calls = []

    def from_the_third_on(au):
        calls.append(1)
        return real(au) if len(calls) < 3 else None

    monkeypatch.setattr(h264, "decode_ipcm_au", from_the_third_on)
    got = list(FileSource(str(path)).frames())
    assert len(got) == 5
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(g.frame, r.frame)


def test_other_files_take_cv2_as_in_the_reference(tmp_path):
    path = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12, (64, 48))
    for i in range(6):
        w.write(np.full((48, 64, 3), i * 30, np.uint8))
    w.release()
    got = list(FileSource(path).frames())
    ref = list(RefFileSource(path).frames())
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.frame, r.frame)
        assert g.pts_ns == r.pts_ns
    with pytest.raises(IOError, match="cannot open"):
        list(FileSource(str(tmp_path / "absent.mp4")).frames())


# -------------------------------------------------- worker and the pool


def _counters(obj) -> tuple:
    return obj.frames_decoded, obj.frames_dropped, obj.error


@pytest.mark.parametrize("drop", [True, False])
def test_decode_worker_equals_the_references(drop):
    ours = DecodeWorker("s", lambda: SyntheticSource(32, 24, count=12),
                        maxsize=4, drop_when_full=drop)
    ref = RefWorker("s", lambda: RefSynthetic(32, 24, count=12),
                    maxsize=4, drop_when_full=drop)
    out = {}
    for name, worker in (("ours", ours), ("ref", ref)):
        worker.start()
        if drop:  # a stalled consumer: drop-oldest keeps the newest 4
            # (the end-of-stream marker then waits for room: the source
            # is done once all 12 are decoded)
            _await(lambda w=worker: w.frames_decoded == 12, 10)
        got = []
        while (ev := worker.queue.get(timeout=10)) is not None:
            got.append(ev)
        worker.stop()
        out[name] = got
        assert all(ev.decode_s is not None for ev in got)
    assert [e.seq for e in out["ours"]] == [e.seq for e in out["ref"]]
    for a, b in zip(out["ours"], out["ref"]):
        np.testing.assert_array_equal(a.frame, b.frame)
    assert _counters(ours) == _counters(ref)
    assert ours.frames_dropped == (8 if drop else 0)


def test_decode_worker_restarts_as_the_reference():
    def flaky(cls):
        calls = []

        def factory():
            calls.append(1)
            if len(calls) <= 2:
                raise IOError("camera gone")
            return cls(16, 16, count=3)
        return factory

    ours = DecodeWorker("s", flaky(SyntheticSource), restart_backoff_s=0.01)
    ref = RefWorker("s", flaky(RefSynthetic), restart_backoff_s=0.01)
    for w in (ours, ref):
        w.start()
        w._thread.join(10)
    assert _counters(ours) == _counters(ref) == (3, 0, "camera gone")
    dead = DecodeWorker("d", lambda: (_ for _ in ()).throw(IOError("x")),
                        max_restarts=0)
    dead.start()
    assert dead.queue.get(timeout=10) is None and dead.error == "x"


def test_decode_pool_equals_the_references(tmp_path):
    path = tmp_path / "cam.mjpeg"
    _write_mjpeg(path, 4)
    results = {}
    for name, pool_cls, synth in (("ours", DecodePool, SyntheticSource),
                                  ("ref", RefPool, RefSynthetic)):
        pool = pool_cls(workers=2)
        streams = [pool.add_stream(f"s{i}", lambda i=i: synth(16, 16, count=5,
                                                              seed=i),
                                   drop_when_full=False) for i in range(3)]
        got = [[ev.frame for ev in ps.frames()] for ps in streams]
        stats = pool.stats()
        pool.stop()
        results[name] = (got, stats)
    for a, b in zip(results["ours"][0], results["ref"][0]):
        assert len(a) == len(b) == 5
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert results["ours"][1] == results["ref"][1]
    # a file through the pool: the frames of the file read directly
    pool = DecodePool(workers=1)
    ps = pool.add_stream("f", lambda: FileSource(str(path)),
                         drop_when_full=False)
    pooled = [ev.frame for ev in ps.frames()]
    pool.stop()
    direct = [ev.frame for ev in FileSource(str(path)).frames()]
    assert len(pooled) == 4
    for a, b in zip(pooled, direct):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ webcam and gige


class _FakeCapture:
    """cv2.VideoCapture's contract over three synthetic frames."""

    def __init__(self, target, *_):
        self.target = target
        self.frames = _frames(3, 24, 32)

    def isOpened(self):
        return self.target in (0, 1) or "aravissrc" in str(self.target)

    def get(self, prop):
        return 30.0

    def read(self):
        if not self.frames:
            return False, None
        return True, self.frames.pop(0)

    def release(self):
        pass


def _fake_cv2(gstreamer: bool = False):
    mod = types.ModuleType("cv2")
    mod.VideoCapture = _FakeCapture
    mod.getBuildInformation = lambda: "GStreamer: YES" if gstreamer else ""
    mod.CAP_GSTREAMER = 1800
    return mod


def test_webcam_source_reads_cv2_and_names_it_without_it(monkeypatch):
    src = create_source({"type": "webcam", "device": "1"})
    assert isinstance(src, WebcamSource) and src.index == 1
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2())
    assert len(list(src.frames())) == 3
    with pytest.raises(IOError, match="cannot open camera 7"):
        list(WebcamSource(7).frames())
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        list(create_source({"type": "webcam"}).frames())


def test_gige_source_and_pixel_formats_equal_the_references(monkeypatch):
    rng = np.random.default_rng(4)
    mono = rng.integers(0, 256, (8, 8), np.uint8)
    rgb = rng.integers(0, 256, (8, 8, 3), np.uint8)
    for fmt, data in (("Mono8", mono), ("BayerRG8", mono), ("BayerGB8", mono),
                      ("BayerGR8", mono), ("BayerBG8", mono), ("RGB8", rgb),
                      ("BGR8", rgb)):
        np.testing.assert_array_equal(gige_frame_to_bgr(data, fmt),
                                      ref_gige(data, fmt))
    with pytest.raises(ValueError, match="Packed10"):
        gige_frame_to_bgr(mono, "Packed10")
    src = create_source({"type": "gige", "serial": "cam-042",
                         "pixel-format": "Mono8"})
    assert isinstance(src, GigeSource) and src.serial == "cam-042"
    monkeypatch.setitem(sys.modules, "harvesters", None)
    monkeypatch.setitem(sys.modules, "harvesters.core", None)
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2())
    with pytest.raises(RuntimeError, match="GenTL|GStreamer"):
        next(src.frames())
    # cv2 built with GStreamer: the aravissrc capture
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2(gstreamer=True))
    cam = GigeSource(serial="cam-042")
    assert len(list(cam.frames())) == 3
    assert "serial=cam-042" in cam._cap.target
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        next(GigeSource().frames())


# ----------------------------------------------------- through the registry


def _registry(tmp_path: Path | None = None, **settings) -> PipelineRegistry:
    models = ModelRegistry(device="cpu", input_overrides={KEY: (64, 64)},
                           width_overrides={KEY: 8}, allow_random_weights=True)
    hub = EngineHub(models, device="cpu", max_batch=8, deadline_ms=4.0)
    return PipelineRegistry(Settings(pipelines_dir=str(REPO / "pipelines"),
                                     device="cpu", drain_timeout_s=10.0,
                                     **settings), hub=hub)


def _request(uri: str, out: Path, frame: dict | None = None) -> dict:
    body = {"source": {"uri": uri, "type": "uri"},
            "destination": {"metadata": {"type": "file", "path": str(out)}},
            "parameters": {"threshold": 0.0}}
    if frame is not None:
        body["destination"]["frame"] = frame
    return body


def _lines(path: Path) -> list[dict]:
    return [json.loads(x) for x in path.read_text().splitlines()] \
        if path.exists() else []


def _await(pred, timeout: float = 60.0, what: str = "") -> None:
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, what
        time.sleep(0.05)


class _Cameras:
    """The port's RtspServer with looping synthetic cameras."""

    def __init__(self, codecs=("jpeg",), h: int = 48, w: int = 64):
        self.srv = RtspServer(port=0, host="127.0.0.1")
        self.srv.start()
        self.stop_ev = threading.Event()
        for i, codec in enumerate(codecs):
            relay = self.srv.mount(f"cam{i}", codec=codec)
            blobs = [jpeg.encode(f, 80) if codec == "jpeg"
                     else h264.encode_frames([f])
                     for f in _frames(8, h, w, seed=i)]
            threading.Thread(target=self._feed, args=(relay, blobs),
                             daemon=True).start()

    def _feed(self, relay, blobs):
        k = 0
        while not self.stop_ev.is_set():
            relay.push_jpeg(blobs[k % len(blobs)])
            k += 1
            time.sleep(1 / 30)

    def url(self, i: int) -> str:
        return f"rtsp://127.0.0.1:{self.srv.port}/cam{i}"

    def close(self):
        self.stop_ev.set()
        self.srv.stop()


def test_files_through_the_decode_pool(tmp_path):
    reg = _registry(decode_pool_workers=1)
    server = make_server(App(reg), "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        _write_h264(tmp_path / "a.h264", 4)
        _write_mjpeg(tmp_path / "b.mjpeg", 3)
        insts = [reg.start_instance(*PIPE, _request(
            str(tmp_path / name), tmp_path / f"{name}.jsonl"))
            for name in ("a.h264", "b.mjpeg")]
        for inst in insts:
            inst.wait(60)
            assert inst.state.value == "COMPLETED", inst.status()
        assert len(_lines(tmp_path / "a.h264.jsonl")) == 4
        assert len(_lines(tmp_path / "b.mjpeg.jsonl")) == 3
        url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["decode_pool"]["decoded"] == 7
        assert health["decode_pool"]["workers"] == 1
        assert "rtsp_demux" not in health
    finally:
        server.shutdown()
        server.server_close()
        reg.stop_all()
    assert reg.decode_pool._stop


@pytest.mark.parametrize("demux_workers", [2, 0])
def test_cameras_through_the_demux_or_their_own_reader(tmp_path,
                                                       demux_workers):
    cams = _Cameras(("jpeg", "h264"))
    reg = _registry(rtsp_demux_workers=demux_workers)
    try:
        insts = [reg.start_instance(*PIPE, _request(
            cams.url(i), tmp_path / f"{i}.jsonl")) for i in range(2)]
        for i in range(2):
            _await(lambda i=i: len(_lines(tmp_path / f"{i}.jsonl")) >= 3,
                   what=f"camera {i} published nothing")
        if demux_workers:
            stats = reg.rtsp_demux.stats()
            assert stats["streams"] == 2 and stats["threads"] == 3
        else:
            assert reg.rtsp_demux is None
        for inst in insts:
            reg.stop_instance(inst.id)
            inst.wait(30)
            assert inst.state.value == "ABORTED"
    finally:
        reg.stop_all()
        cams.close()


def test_rtsp_frame_destination(tmp_path, monkeypatch):
    """Mounted at the request's path, annotated and encoded only while a
    client watches, unmounted when the instance stops and when a start
    fails after mounting."""
    pushes = []
    real_push = FrameRelay.push_bgr
    monkeypatch.setattr(FrameRelay, "push_bgr", lambda self, f, q=80: (
        pushes.append(f.shape), real_push(self, f, q)))
    cams = _Cameras()
    reg = _registry()
    reg.rtsp = RtspServer(port=0, host="127.0.0.1")
    reg.rtsp.start()
    demux = RtspDemux(decode_workers=1)
    try:
        inst = reg.start_instance(*PIPE, _request(
            cams.url(0), tmp_path / "o.jsonl", {"type": "rtsp",
                                                 "path": "/out/"}))
        assert "out" in reg.rtsp._mounts
        _await(lambda: len(_lines(tmp_path / "o.jsonl")) >= 3)
        assert pushes == []  # nobody watches: no annotate, no encode
        stream = demux.add_stream(
            f"rtsp://127.0.0.1:{reg.rtsp.port}/out")
        frames = []
        for ev in stream.frames():
            frames.append(ev.frame)
            if len(frames) == 2:
                break
        stream.close()
        assert frames[0].shape == (48, 64, 3) and pushes
        reg.stop_instance(inst.id)
        inst.wait(30)
        _await(lambda: "out" not in reg.rtsp._mounts, 10)
        # a start that fails after mounting leaves no mount behind
        monkeypatch.setattr(registry_mod, "build_stages",
                            lambda *a, **k: (_ for _ in ()).throw(
                                RuntimeError("no stages")))
        with pytest.raises(RuntimeError, match="no stages"):
            reg.start_instance(*PIPE, _request(
                cams.url(0), tmp_path / "p.jsonl", {"type": "rtsp",
                                                     "path": "gone"}))
        assert "gone" not in reg.rtsp._mounts
    finally:
        demux.stop()
        reg.stop_all()
        reg.rtsp.stop()
        cams.close()


def test_a_resumed_stream_mounts_its_frame_destination_again(tmp_path):
    cams = _Cameras()
    state = tmp_path / "state"
    reg = _registry(state_dir=str(state))
    reg.rtsp = RtspServer(port=0, host="127.0.0.1")
    try:
        reg.start_instance(*PIPE, _request(cams.url(0), tmp_path / "o.jsonl",
                                           {"type": "rtsp", "path": "re"}))
        _await(lambda: len(_lines(tmp_path / "o.jsonl")) >= 2)
        reg.stop_all()
        assert "re" in json.dumps(json.loads(
            (state / "streams.json").read_text()))
        again = _registry(state_dir=str(state))
        again.rtsp = RtspServer(port=0, host="127.0.0.1")
        try:
            assert "re" not in again.rtsp._mounts
            assert again.resume() == 1
            assert "re" in again.rtsp._mounts
        finally:
            again.stop_all()
    finally:
        cams.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_starts_the_rtsp_server_with_enable_rtsp(tmp_path):
    rest, rtsp = _free_port(), _free_port()
    env = dict(os.environ, EVAM_PLATFORM="cpu", EVAM_WARMUP="0",
               REST_PORT=str(rest), ENABLE_RTSP="1", RTSP_PORT=str(rtsp),
               EVAM_RTSP_DEMUX_WORKERS="1", EVAM_DECODE_POOL_WORKERS="1")
    log_path = tmp_path / "serve.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{rest}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                    break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, \
                    log_path.read_text()[-2000:]
                time.sleep(0.2)
        assert health["rtsp_demux"]["threads"] == 2
        assert health["decode_pool"]["workers"] == 1
        assert f"rtsp://0.0.0.0:{rtsp}" in log_path.read_text()
        with socket.create_connection(("127.0.0.1", rtsp), timeout=10) as s:
            s.sendall(b"OPTIONS rtsp://127.0.0.1/x RTSP/1.0\r\nCSeq: 1\r\n\r\n")
            assert s.recv(256).startswith(b"RTSP/1.0 200 OK")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ----------------------------------------------------- without cv2

_NO_CV2 = r'''
import sys
sys.modules["cv2"] = None
import json, threading, time
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.media import h264, jpeg
from evam_tpu_torch.media.demux import RtspDemux
from evam_tpu_torch.media.source import SyntheticSource
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.publish.encode import decode_frame, encode_frame
from evam_tpu_torch.publish.rtsp import RtspServer
from evam_tpu_torch.server.registry import PipelineRegistry

repo, tmp = Path(sys.argv[1]), Path(sys.argv[2])
key = "object_detection/person_vehicle_bike"
models = ModelRegistry(device="cpu", input_overrides={key: (64, 64)},
                       width_overrides={key: 8}, allow_random_weights=True)
hub = EngineHub(models, device="cpu", max_batch=8, deadline_ms=4.0)
reg = PipelineRegistry(Settings(pipelines_dir=str(repo / "pipelines"),
                                device="cpu", rtsp_demux_workers=2,
                                decode_pool_workers=1), hub=hub)
reg.rtsp = RtspServer(port=0, host="127.0.0.1")
reg.rtsp.start()
cams = RtspServer(port=0, host="127.0.0.1")
cams.start()
stop = threading.Event()
frames = [ev.frame for ev in SyntheticSource(64, 48, count=8).frames()]

def feed(relay, push):
    k = 0
    while not stop.is_set():
        push(relay, frames[k % len(frames)])
        k += 1
        time.sleep(1 / 30)

threading.Thread(target=feed, args=(cams.mount("mjpeg"),
                 lambda r, f: r.push_bgr(f)), daemon=True).start()
threading.Thread(target=feed, args=(cams.mount("ipcm", codec="h264"),
                 lambda r, f: r.push_annexb(h264.encode_frames([f]))),
                 daemon=True).start()
h264.write_annexb(str(tmp / "a.h264"), frames[:4])
(tmp / "b.mjpeg").write_bytes(b"".join(jpeg.encode(f) for f in frames[:3]))

def start(uri, name, frame=None):
    dest = {"metadata": {"type": "file", "path": str(tmp / name)}}
    if frame:
        dest["frame"] = frame
    return reg.start_instance("object_detection", "person_vehicle_bike", {
        "source": {"uri": uri, "type": "uri"}, "destination": dest,
        "parameters": {"threshold": 0.0}})

url = f"rtsp://127.0.0.1:{cams.port}/"
cam0 = start(url + "mjpeg", "c0.jsonl", {"type": "rtsp", "path": "out"})
cam1 = start(url + "ipcm", "c1.jsonl")
files = [start(str(tmp / "a.h264"), "a.jsonl"),
         start(str(tmp / "b.mjpeg"), "b.jsonl")]
mp4 = start(str(tmp / "clip.mp4"), "m.jsonl")
blob = encode_frame(frames[0], "jpeg", 90)
assert decode_frame(blob, "jpeg").shape == (48, 64, 3)
demux = RtspDemux(decode_workers=1)
stream = demux.add_stream(f"rtsp://127.0.0.1:{reg.rtsp.port}/out")
n = 0
for ev in stream.frames():
    assert ev.frame.shape == (48, 64, 3)
    n += 1
    if n == 2:
        break
stream.close()
demux.stop()
for inst, want in zip(files, (4, 3)):
    inst.wait(60)
    lines = (tmp / ("a.jsonl" if want == 4 else "b.jsonl")).read_text()
    assert inst.state.value == "COMPLETED" and len(lines.splitlines()) == want
deadline = time.time() + 60
while any(not (tmp / f).exists() or len((tmp / f).read_text().splitlines()) < 3
          for f in ("c0.jsonl", "c1.jsonl")):
    assert time.time() < deadline, "a camera published nothing"
    time.sleep(0.05)
mp4.wait(60)
assert mp4.state.value == "ERROR" and "cv2" in mp4.error, mp4.status()
stop.set()
reg.stop_all()
reg.rtsp.stop()
cams.stop()
assert not any(m == "cv2" or m.startswith("cv2.") for m in sys.modules
               if sys.modules[m] is not None)
print("OK")
'''


def test_the_ingest_path_serves_with_cv2_blocked(tmp_path):
    res = subprocess.run([sys.executable, "-c", _NO_CV2, str(REPO),
                          str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), \
        res.stderr[-3000:]
