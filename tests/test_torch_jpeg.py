"""The port's JPEG codec (``csrc/evam_codec.cpp`` through
``evam_tpu_torch/media/jpeg.py``) against cv2 (libjpeg-turbo).

* Decode: ``cv2.imencode`` output at quality 50, 80 and 95, sampled
  4:2:0, 4:4:4, 4:2:2 and 4:4:0, with and without restart intervals,
  grayscale too, and the JFIF that ``reconstruct_jfif`` rebuilds from
  RFC 2435 types 0 and 1 (Q < 128 tables derived from Q, Q ≥ 128 tables
  in-band): the port's frame equals ``cv2.imdecode``'s bit for bit.
* Encode: the port's bytes equal ``cv2.imencode``'s at the same quality
  (so ``cv2.imdecode`` of either gives the same frame), from quality 0
  to 100, at sizes that are and are not a multiple of the 16-pixel MCU.
* Progressive, arithmetic-coded, lossless, hierarchical and 12-bit
  streams raise naming their SOF; so do streams that are not JPEG, and
  headers past cv2's 2^30-pixel limit. A codec that cannot be built
  raises with the compiler's output.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from evam_tpu.media.demux import rfc2435_qtables as ref_qtables  # noqa: E402
from evam_tpu.media.demux import reconstruct_jfif as ref_jfif  # noqa: E402
from evam_tpu.publish.rtsp import parse_jpeg as ref_parse_jpeg  # noqa: E402
from evam_tpu_torch import native  # noqa: E402
from evam_tpu_torch.media import jpeg  # noqa: E402

torch.set_num_threads(1)

#: (height, width): MCU multiples, odd sizes, one-pixel edges
SIZES = [(48, 64), (37, 53), (17, 9), (1, 1), (2, 3), (90, 94)]
SAMPLING = {
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
}


def _image(h: int, w: int, seed: int, kind: str = "mixed") -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    f = np.stack([(x * 3 + y) % 256, (y * 2) % 256, ((x + y) * 5) % 256], -1)
    f = f + rng.integers(-20, 21, (h, w, 3))
    f[h // 3:h // 2, w // 4:w // 2] = (40, 200, 90)
    return np.clip(f, 0, 255).astype(np.uint8)


def _cv2_jpeg(frame, quality, sampling="420", rst=0, gray=False) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    img = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if gray else frame
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _cv2_decode(blob: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)


# ------------------------------------------------------------- decode


@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("sampling", ["420", "444"])
@pytest.mark.parametrize("quality", [50, 80, 95])
def test_decode_equals_cv2(quality, sampling, rst):
    for i, (h, w) in enumerate(SIZES):
        for kind in ("mixed", "noise"):
            blob = _cv2_jpeg(_image(h, w, i, kind), quality, sampling, rst)
            np.testing.assert_array_equal(jpeg.decode(blob), _cv2_decode(blob))


@pytest.mark.parametrize("sampling", ["422", "440"])
def test_decode_of_other_samplings_equals_cv2(sampling):
    for i, (h, w) in enumerate(SIZES):
        blob = _cv2_jpeg(_image(h, w, i), 80, sampling, rst=3)
        np.testing.assert_array_equal(jpeg.decode(blob), _cv2_decode(blob))


def test_grayscale_decodes_to_bgr_as_cv2():
    for i, (h, w) in enumerate(SIZES):
        blob = _cv2_jpeg(_image(h, w, i), 80, gray=True)
        got = jpeg.decode(blob)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _cv2_decode(blob))


@pytest.mark.parametrize("q", [20, 50, 80, 99, 255])
@pytest.mark.parametrize("rtp_type", [0, 1])
def test_rfc2435_rebuilt_jfif_decodes_as_cv2(rtp_type, q):
    """A camera's RFC 2435 frame as the demux rebuilds it: type 0 (4:2:2)
    or 1 (4:2:0), tables derived from Q < 128 or carried in-band."""
    h, w = 48, 80
    sampling = "422" if rtp_type == 0 else "420"
    blob = _cv2_jpeg(_image(h, w, q), 80 if q >= 128 else q, sampling)
    width, height, qtables, scan = ref_parse_jpeg(blob)
    tables = qtables if q >= 128 else ref_qtables(q)
    jfif = ref_jfif(width, height, tables, scan, subsampling=rtp_type)
    np.testing.assert_array_equal(jpeg.decode(jfif), _cv2_decode(jfif))
    assert jpeg.info(jfif) == (h, w)


def test_a_cut_stream_decodes_as_libjpeg_does_or_raises():
    blob = _cv2_jpeg(_image(48, 64, 0), 80)
    # cut inside the scan: libjpeg warns and fills the rest with zero
    # bits (cv2.imdecode gives up on the warning); the MCU rows before
    # the cut are the whole stream's
    cut = blob[:len(blob) - 200]
    got = jpeg.decode(cut)
    assert got.shape == (48, 64, 3)
    np.testing.assert_array_equal(got[:16], _cv2_decode(blob)[:16])
    for bad in (b"", b"\xff\xd8", b"GIF89a" + bytes(40), blob[:30]):
        with pytest.raises(ValueError, match="jpeg:"):
            jpeg.decode(bad)


# ------------------------------------------------------------- encode


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53), (1, 1), (17, 9),
                                 (90, 94), (64, 97)])
def test_encode_bytes_equal_cv2(h, w):
    for quality in (0, 1, 10, 25, 50, 75, 80, 95, 100):
        for kind in ("mixed", "noise"):
            frame = _image(h, w, quality, kind)
            ok, ref = cv2.imencode(".jpg", frame,
                                   [cv2.IMWRITE_JPEG_QUALITY, quality])
            got = jpeg.encode(frame, quality)
            assert got == ref.tobytes(), (h, w, quality, kind)
            np.testing.assert_array_equal(_cv2_decode(got), _cv2_decode(ref))


def test_encode_takes_strided_frames_and_refuses_other_shapes():
    frame = _image(40, 60, 1)[:, ::-1]  # a negative stride
    ok, ref = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert jpeg.encode(frame) == ref.tobytes()
    for bad in (np.zeros((8, 8), np.uint8), np.zeros((8, 8, 4), np.uint8),
                np.zeros((8, 8, 3), np.float32)):
        with pytest.raises(ValueError, match="BGR uint8"):
            jpeg.encode(bad)


def test_round_trip_is_deterministic():
    frame = _image(120, 160, 3)
    blob = jpeg.encode(frame, 80)
    assert jpeg.encode(frame, 80) == blob
    np.testing.assert_array_equal(jpeg.decode(blob), jpeg.decode(blob))


# ------------------------------------------------------------- refusals


def _with_sof(blob: bytes, marker: int, precision: int | None = None) -> bytes:
    i = blob.index(b"\xff\xc0")
    out = bytearray(blob)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("make,needle", [
    (lambda b, f: cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
     .tobytes(), "progressive DCT \\(SOF2\\)"),
    (lambda b, f: _with_sof(b, 0xC9), "arithmetic coding \\(SOF9\\)"),
    (lambda b, f: _with_sof(b, 0xC3), "lossless \\(SOF3\\)"),
    (lambda b, f: _with_sof(b, 0xC5), "hierarchical \\(SOF5\\)"),
    (lambda b, f: _with_sof(b, 0xC1, precision=12), "12-bit samples \\(SOF1\\)"),
], ids=["progressive", "arithmetic", "lossless", "hierarchical", "12-bit"])
def test_refused_sofs_raise_naming_them(make, needle):
    frame = _image(32, 48, 0)
    blob = make(jpeg.encode(frame, 80), frame)
    with pytest.raises(ValueError, match=needle):
        jpeg.decode(blob)
    with pytest.raises(ValueError, match=needle):
        jpeg.info(blob)


def _with_size(blob: bytes, h: int, w: int) -> bytes:
    i = blob.index(b"\xff\xc0")
    out = bytearray(blob)
    out[i + 5:i + 9] = h.to_bytes(2, "big") + w.to_bytes(2, "big")
    return bytes(out)


@pytest.mark.parametrize("h,w", [(65535, 65535), (32768, 32769)])
def test_a_header_past_cv2s_pixel_limit_raises_before_reserving(h, w):
    """A few hundred bytes (a bus frame, a cut ``.mjpeg``) must not make
    a decode reserve gigabytes: past 2^30 pixels, cv2's
    ``CV_IO_MAX_IMAGE_PIXELS``, both the Python entry and the codec
    refuse, as ``cv2.imdecode`` does."""
    blob = _with_size(jpeg.encode(_image(16, 16, 0), 80), h, w)
    assert h * w > jpeg.MAX_PIXELS
    try:  # cv2 refuses too: None, or an error naming the limit
        assert _cv2_decode(blob) is None
    except cv2.error as exc:
        assert "CV_IO_MAX_IMAGE_PIXELS" in str(exc)
    with pytest.raises(ValueError, match="more than 2\\^30 pixels"):
        jpeg.decode(blob)
    with pytest.raises(ValueError, match="more than 2\\^30 pixels"):
        jpeg.info(blob)  # the codec's own check


def test_a_codec_that_does_not_build_raises_with_its_output(tmp_path,
                                                            monkeypatch):
    """No numpy or cv2 stand-in: a failed build is the error."""
    broken = tmp_path / "evam_codec.cpp"
    broken.write_text("int evam_codec_version( { return 1; }\n")
    monkeypatch.setattr(native, "CODEC_SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("EVAM_NATIVE_LIB", raising=False)
    with pytest.raises(RuntimeError, match="failed") as info:
        jpeg.decode(b"\xff\xd8\xff\xd9")
    assert "error" in str(info.value)
    with pytest.raises(RuntimeError, match="failed"):
        jpeg.encode(_image(8, 8, 0))


def test_concurrent_calls_give_the_same_bytes_and_frames():
    """The codec runs with the interpreter lock released (the demux's
    decode workers call it at once): more threads than cores, each
    encoding and decoding its own frames, agree with one thread's
    results."""
    import os
    import threading

    frames = [_image(40 + 8 * i, 56, i) for i in range(6)]
    want = [(jpeg.encode(f, 80), jpeg.decode(jpeg.encode(f, 80)))
            for f in frames]
    errors = []

    def work(k: int) -> None:
        for r in range(20):
            i = (k + r) % len(frames)
            blob = jpeg.encode(frames[i], 80)
            if blob != want[i][0] or not np.array_equal(jpeg.decode(blob),
                                                        want[i][1]):
                errors.append((k, r))

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(2 * (os.cpu_count() or 2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
