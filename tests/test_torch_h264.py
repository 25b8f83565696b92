"""The port's H.264 and RTP byte work against the reference's
(``evam_tpu.media.h264``, ``evam_tpu.media.demux``,
``evam_tpu.publish.rtsp``) on the same seeded inputs.

* ``encode_frames`` / ``write_annexb``: equal bytes, BGR or plane
  input, sizes that are and are not a multiple of 16 (the crop);
* ``decode_ipcm_au``: equal frames, and ``None`` for the same foreign
  access units;
* ``split_annexb``, ``packetize_rfc6184``, ``packetize_jpeg``,
  ``parse_jpeg``, ``rfc2435_qtables``, ``reconstruct_jfif``: equal bytes;
* the colour conversions equal cv2's (``COLOR_BGR2YUV_I420`` and
  ``COLOR_YUV2BGR_I420``), which the reference calls.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from evam_tpu.media import demux as ref_demux  # noqa: E402
from evam_tpu.media import h264 as ref_h264  # noqa: E402
from evam_tpu.publish import rtsp as ref_rtsp  # noqa: E402
from evam_tpu_torch import native  # noqa: E402
from evam_tpu_torch.media import demux, h264  # noqa: E402
from evam_tpu_torch.publish import rtsp  # noqa: E402

torch.set_num_threads(1)

#: (height, width): even, height a multiple of 4 (the I420 layout); 16
#: multiples and not (cropped)
SIZES = [(16, 16), (32, 48), (36, 52), (64, 96), (120, 200)]


def _frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    f[:, : h // 2] = 0  # zero runs: emulation prevention at work
    return f


@pytest.mark.parametrize("h,w", SIZES)
def test_encode_frames_bytes_equal_the_references(h, w, tmp_path):
    frames = _frames(3, h, w, h * w)
    assert h264.encode_frames(frames) == ref_h264.encode_frames(frames)
    planes = [ref_h264.bgr_to_i420_planes(f) for f in frames]
    assert h264.encode_frames(planes) == ref_h264.encode_frames(planes)
    ours = h264.write_annexb(str(tmp_path / "a.h264"), frames)
    ref = ref_h264.write_annexb(str(tmp_path / "b.h264"), frames)
    assert open(ours, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("h,w", SIZES)
def test_decode_ipcm_au_frames_equal_the_references(h, w):
    for i, f in enumerate(_frames(2, h, w, 7 + h)):
        au = ref_h264.encode_frames([f])
        got, want = h264.decode_ipcm_au(au), ref_h264.decode_ipcm_au(au)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want)


def test_foreign_access_units_are_none_in_both():
    au = ref_h264.encode_frames(_frames(1, 32, 32, 1))
    nals = ref_h264.split_annexb(au)
    sps, pps, idr = nals
    main_profile = bytes([sps[0], 77]) + sps[2:]      # not baseline
    p_slice = bytes([idr[0] & 0xE0 | 1]) + idr[1:]    # no IDR in the AU
    short = idr[:200]                                 # payload cut
    for variant in ([main_profile, pps, idr], [sps, pps, p_slice],
                    [sps, pps, short], [pps, idr], []):
        blob = b"".join(b"\x00\x00\x00\x01" + n for n in variant)
        assert h264.decode_ipcm_au(blob) is None
        assert ref_h264.decode_ipcm_au(blob) is None


def test_emulation_prevention_equals_the_references():
    rng = np.random.default_rng(3)
    cases = [bytes(rng.choice([0, 0, 0, 1, 2, 3, 4, 255], 400))
             for _ in range(50)]
    cases += [b"\x00" * n for n in range(8)] + [b"\x00\x00\x03\x00\x00\x00"]
    for rbsp in cases:
        assert h264._ep_escape(rbsp) == ref_h264._ep_escape(rbsp)


def test_colour_conversions_equal_cv2(monkeypatch):
    # the codec loads the library whatever the policy says
    monkeypatch.setenv("EVAM_NO_NATIVE", "1")
    rng = np.random.default_rng(0)
    for h, w in SIZES:
        bgr = rng.integers(0, 256, (h, w, 3), np.uint8)
        y, u, v = h264.bgr_to_i420_planes(bgr)
        planar = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
        np.testing.assert_array_equal(y, planar[:h])
        np.testing.assert_array_equal(u.reshape(-1),
                                      planar[h:h + h // 4].reshape(-1))
        np.testing.assert_array_equal(v.reshape(-1),
                                      planar[h + h // 4:].reshape(-1))
        planar = rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
        planes = (planar[:h], planar[h:h + h // 4].reshape(h // 2, w // 2),
                  planar[h + h // 4:].reshape(h // 2, w // 2))
        want = cv2.cvtColor(planar, cv2.COLOR_YUV2BGR_I420)
        np.testing.assert_array_equal(native.i420_to_bgr(*planes), want)
    with pytest.raises(ValueError, match="even"):
        h264.bgr_to_i420_planes(np.zeros((3, 4, 3), np.uint8))


def test_split_annexb_equals_the_references():
    rng = np.random.default_rng(5)
    for _ in range(30):
        parts = [bytes(rng.integers(1, 256, rng.integers(1, 50), np.uint8))
                 for _ in range(rng.integers(1, 6))]
        blob = b"".join((b"\x00\x00\x00\x01" if rng.random() < 0.5
                         else b"\x00\x00\x01") + p for p in parts)
        assert h264.split_annexb(blob) == ref_h264.split_annexb(blob) == parts
    assert h264.split_annexb(b"no start code") == []


@pytest.mark.parametrize("mtu", [1400, 100, 7])
def test_packetize_rfc6184_equals_the_references(mtu):
    au = ref_h264.encode_frames(_frames(1, 48, 64, 2))
    for seq, ts in ((0, 0), (65534, 2**32 - 10), (17, 90000)):
        got = h264.packetize_rfc6184(au, seq, ts, 0x1234, mtu=mtu)
        assert got == ref_h264.packetize_rfc6184(au, seq, ts, 0x1234, mtu=mtu)
        assert got[1] == seq + len(got[0])


def _jpeg(h: int, w: int, seed: int, q: int = 80) -> bytes:
    f = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()


@pytest.mark.parametrize("h,w", [(48, 64), (8, 8), (200, 320)])
def test_parse_and_packetize_jpeg_equal_the_references(h, w):
    blob = _jpeg(h, w, h)
    assert rtsp.parse_jpeg(blob) == ref_rtsp.parse_jpeg(blob)
    for seq, ts in ((0, 0), (65535, 123456)):
        assert rtsp.packetize_jpeg(blob, seq, ts, 7) == \
            ref_rtsp.packetize_jpeg(blob, seq, ts, 7)
    for bad in (b"GIF89a", b"\xff\xd8\x00\x00", b"\xff\xd8\xff\xd9"):
        with pytest.raises(ValueError) as ours:
            rtsp.parse_jpeg(bad)
        with pytest.raises(ValueError) as ref:
            ref_rtsp.parse_jpeg(bad)
        assert str(ours.value) == str(ref.value)


def test_packetize_jpeg_refuses_what_the_reference_refuses():
    blob = _jpeg(8, 2048, 0)
    with pytest.raises(ValueError, match="2040"):
        rtsp.packetize_jpeg(blob, 0, 0, 1)
    with pytest.raises(ValueError, match="2040"):
        ref_rtsp.packetize_jpeg(blob, 0, 0, 1)


def test_rfc2435_tables_and_rebuilt_jfif_equal_the_references():
    for q in range(0, 140):
        assert demux.rfc2435_qtables(q) == ref_demux.rfc2435_qtables(q)
    blob = _jpeg(48, 80, 9)
    width, height, qtables, scan = ref_rtsp.parse_jpeg(blob)
    for sub in (0, 1):
        for tables in (qtables, qtables[:1], demux.rfc2435_qtables(40)):
            assert demux.reconstruct_jfif(width, height, tables, scan, sub) \
                == ref_demux.reconstruct_jfif(width, height, tables, scan, sub)


def test_sdp_parse_and_control_resolution_equal_the_references():
    sdps = [
        "v=0\r\nm=video 0 RTP/AVP 26\r\na=control:streamid=0\r\n",
        "v=0\r\na=control:*\r\nm=video 0 RTP/AVP 96\r\n"
        "a=rtpmap:96 H264/90000\r\na=fmtp:96 packetization-mode=1\r\n"
        "a=control:trackID=1\r\n",
        "v=0\r\nm=audio 0 RTP/AVP 0\r\na=control:trackID=0\r\n"
        "m=video 0 RTP/AVP 97\r\na=rtpmap:97 H264/90000\r\n"
        "a=fmtp:97 packetization-mode=2\r\n",
        "v=0\r\nm=video 0 RTP/AVP 98\r\na=rtpmap:98 VP8/90000\r\n",
    ]
    for sdp in sdps:
        got = demux._parse_sdp_media(sdp)
        assert got == ref_demux._parse_sdp_media(sdp)
        for base in ("rtsp://h:554/cam", "rtsp://h/cam/"):
            assert demux._resolve_control(base, got["control"]) == \
                ref_demux._resolve_control(base, got["control"])
