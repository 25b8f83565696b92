"""Intra-only H.264 (AVC) Annex-B: the I_PCM writer and reader, the
Annex-B splitter and the RFC 6184 packetizer.

Counterpart of ``evam_tpu/media/h264.py``. :func:`encode_frames` writes
a legal baseline-profile stream whose every macroblock is I_PCM
(ITU-T H.264 §7.3.5: uncompressed samples inside the bitstream): every
frame an IDR, ``idr_pic_id`` alternating, sizes that are not a multiple
of 16 edge-padded to the coded size with the SPS crop rectangle.
:func:`decode_ipcm_au` reads that dialect back in one numpy pass and
returns ``None`` for anything else (a camera's CAVLC or CABAC stream),
which its callers hand to cv2's decoder.

The reference converts colour with cv2 (``COLOR_BGR2YUV_I420`` and
``COLOR_YUV2BGR_I420``); the port does the same fixed-point BT.601
arithmetic (shift 20, chroma from the top-left pixel of each 2×2 block
one way and repeated the other): in numpy to write, and in the native
library to read (``native.i420_to_bgr``, a codec with no numpy
copy), so its bytes and frames equal the reference's without cv2.
"""

from __future__ import annotations

import re
import struct
from typing import Iterator

import numpy as np

from evam_tpu_torch import native


class _BitWriter:
    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    def u(self, value: int, bits: int) -> None:
        for i in range(bits - 1, -1, -1):
            self._cur = (self._cur << 1) | ((value >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self._bytes.append(self._cur)
                self._cur = 0
                self._nbits = 0

    def ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (H.264 §9.1)."""
        v = value + 1
        nbits = v.bit_length()
        self.u(0, nbits - 1)
        self.u(v, nbits)

    def se(self, value: int) -> None:
        """Signed Exp-Golomb: 0,1,-1,2,-2,… → 0,1,2,3,4,…"""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align(self) -> None:
        while self._nbits:
            self.u(0, 1)

    def raw_bytes(self, data: bytes) -> None:
        assert self._nbits == 0, "raw bytes require byte alignment"
        self._bytes.extend(data)

    def trailing(self) -> None:
        """rbsp_trailing_bits: stop bit then align."""
        self.u(1, 1)
        self.align()

    def rbsp(self) -> bytes:
        assert self._nbits == 0
        return bytes(self._bytes)


_EMULATION = re.compile(rb"\x00\x00(?=[\x00-\x03])")


def _ep_escape(rbsp: bytes) -> bytes:
    """Emulation prevention (§7.4.1.1): 00 00 {00,01,02,03} →
    00 00 03 xx. I_PCM payloads are full of zeros, so this is hot: one
    regex pass (non-overlapping matches restart the zero count after
    each inserted 03, as the byte-at-a-time rule does)."""
    return _EMULATION.sub(b"\x00\x00\x03", rbsp)


def _nal(ref_idc: int, nal_type: int, rbsp: bytes) -> bytes:
    return (b"\x00\x00\x00\x01"
            + bytes([(ref_idc << 5) | nal_type])
            + _ep_escape(rbsp))


def _sps(coded_w: int, coded_h: int, crop_right: int = 0,
         crop_bottom: int = 0) -> bytes:
    """``coded_*`` are 16-multiples; crop offsets are in samples
    (must be even — CropUnitX/Y = 2 for 4:2:0 frame macroblocks,
    §7.4.2.1.1), carving e.g. true 1080 out of 1088 coded lines."""
    w = _BitWriter()
    w.u(66, 8)            # profile_idc: baseline
    w.u(0xC0, 8)          # constraint_set0/1, reserved zeros
    w.u(40, 8)            # level_idc 4.0 (1080p-capable)
    w.ue(0)               # seq_parameter_set_id
    w.ue(0)               # log2_max_frame_num_minus4 → max_frame_num 16
    w.ue(2)               # pic_order_cnt_type 2 (output order = decode)
    w.ue(0)               # max_num_ref_frames (intra-only)
    w.u(0, 1)             # gaps_in_frame_num_value_allowed_flag
    w.ue(coded_w // 16 - 1)   # pic_width_in_mbs_minus1
    w.ue(coded_h // 16 - 1)   # pic_height_in_map_units_minus1
    w.u(1, 1)             # frame_mbs_only_flag
    w.u(0, 1)             # direct_8x8_inference_flag
    if crop_right or crop_bottom:
        w.u(1, 1)         # frame_cropping_flag
        w.ue(0)                   # left
        w.ue(crop_right // 2)     # right (CropUnitX = 2)
        w.ue(0)                   # top
        w.ue(crop_bottom // 2)    # bottom (CropUnitY = 2)
    else:
        w.u(0, 1)         # frame_cropping_flag
    w.u(0, 1)             # vui_parameters_present_flag
    w.trailing()
    return _nal(3, 7, w.rbsp())


def _pps() -> bytes:
    w = _BitWriter()
    w.ue(0)               # pic_parameter_set_id
    w.ue(0)               # seq_parameter_set_id
    w.u(0, 1)             # entropy_coding_mode_flag: CAVLC
    w.u(0, 1)             # bottom_field_pic_order_in_frame_present
    w.ue(0)               # num_slice_groups_minus1
    w.ue(0)               # num_ref_idx_l0_default_active_minus1
    w.ue(0)               # num_ref_idx_l1_default_active_minus1
    w.u(0, 1)             # weighted_pred_flag
    w.u(0, 2)             # weighted_bipred_idc
    w.se(0)               # pic_init_qp_minus26
    w.se(0)               # pic_init_qs_minus26
    w.se(0)               # chroma_qp_index_offset
    w.u(0, 1)             # deblocking_filter_control_present_flag
    w.u(0, 1)             # constrained_intra_pred_flag
    w.u(0, 1)             # redundant_pic_cnt_present_flag
    w.trailing()
    return _nal(3, 8, w.rbsp())


def _idr_slice(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               idr_pic_id: int) -> bytes:
    """One IDR slice covering the whole picture, every MB I_PCM."""
    h, wd = y.shape
    mbs_w, mbs_h = wd // 16, h // 16
    w = _BitWriter()
    # slice_header (§7.3.3)
    w.ue(0)               # first_mb_in_slice
    w.ue(7)               # slice_type: I (all slices in picture)
    w.ue(0)               # pic_parameter_set_id
    w.u(0, 4)             # frame_num (log2_max_frame_num = 4)
    w.ue(idr_pic_id)      # idr_pic_id
    # pic_order_cnt_type 2 → nothing; I slice → no ref idx
    w.u(0, 1)             # no_output_of_prior_pics_flag
    w.u(0, 1)             # long_term_reference_flag
    w.se(0)               # slice_qp_delta
    w.ue(25)              # first mb_type I_PCM (I-slice table §7-11)
    w.align()             # pcm_alignment_zero_bit(s)
    # slice_data in raster MB order: each MB's 256 luma, 64 Cb and 64
    # Cr samples; every MB after the first is led by ue(25) + alignment,
    # the two bytes 0D 00
    mbs = np.empty((mbs_h, mbs_w, 386), np.uint8)
    mbs[..., 0], mbs[..., 1] = 0x0D, 0x00
    mbs[..., 2:258] = (y.reshape(mbs_h, 16, mbs_w, 16)
                       .transpose(0, 2, 1, 3).reshape(mbs_h, mbs_w, 256))
    mbs[..., 258:322] = (u.reshape(mbs_h, 8, mbs_w, 8)
                         .transpose(0, 2, 1, 3).reshape(mbs_h, mbs_w, 64))
    mbs[..., 322:] = (v.reshape(mbs_h, 8, mbs_w, 8)
                      .transpose(0, 2, 1, 3).reshape(mbs_h, mbs_w, 64))
    w.raw_bytes(mbs.tobytes()[2:])
    w.trailing()
    return _nal(3, 5, w.rbsp())


def encode_frames(frames: "list[np.ndarray] | np.ndarray") -> bytes:
    """Raw I420-planar or BGR frames → intra-only Annex-B H.264.

    Accepts [N,H,W,3] uint8 BGR (converted with the BT.601 studio
    matrix) or a list of (y,u,v) plane tuples. Non-16-multiple frames
    (e.g. true 1080p) are edge-padded to the coded size and the SPS
    carries the matching crop rectangle, like every real encoder.
    """
    out = bytearray()
    first = True
    idr_id = 0
    for f in frames:
        if isinstance(f, tuple):
            y, u, v = f
        else:
            y, u, v = bgr_to_i420_planes(f)
        h, wd = y.shape
        if h % 2 or wd % 2:
            raise ValueError(f"frame dims must be even, got {y.shape}")
        ch, cw = -h % 16, -wd % 16          # pad to coded size
        if ch or cw:
            y = np.pad(y, ((0, ch), (0, cw)), mode="edge")
            u = np.pad(u, ((0, ch // 2), (0, cw // 2)), mode="edge")
            v = np.pad(v, ((0, ch // 2), (0, cw // 2)), mode="edge")
        if first:
            out += _sps(y.shape[1], y.shape[0],
                        crop_right=cw, crop_bottom=ch) + _pps()
            first = False
        out += _idr_slice(
            np.ascontiguousarray(y), np.ascontiguousarray(u),
            np.ascontiguousarray(v), idr_id)
        idr_id ^= 1      # consecutive IDRs must differ (§7.4.3)
    return bytes(out)


#: cv2's BT.601 fixed point for BGR → I420 (``color_yuv.simd.hpp``,
#: shift 20)
_SHIFT = 20
_HALF = 1 << (_SHIFT - 1)
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448


def bgr_to_i420_planes(
        bgr: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BGR uint8 ``[H, W, 3]`` (H, W even) → the Y, U and V planes, the
    bytes of ``cv2.cvtColor(bgr, COLOR_BGR2YUV_I420)`` (the reference's
    conversion)."""
    h, wd = bgr.shape[:2]
    if h % 2 or wd % 2:
        raise ValueError(f"frame dims must be even, got {bgr.shape[:2]}")
    px = bgr.astype(np.int32)
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    y = (_CRY * r + _CGY * g + _CBY * b + _HALF + (16 << _SHIFT)) >> _SHIFT
    b0, g0, r0 = b[::2, ::2], g[::2, ::2], r[::2, ::2]
    u = (_CRU * r0 + _CGU * g0 + _CBU * b0 + _HALF
         + (128 << _SHIFT)) >> _SHIFT
    v = (_CBU * r0 + _CGV * g0 + _CBV * b0 + _HALF
         + (128 << _SHIFT)) >> _SHIFT
    return (np.clip(y, 0, 255).astype(np.uint8),
            np.clip(u, 0, 255).astype(np.uint8),
            np.clip(v, 0, 255).astype(np.uint8))


def write_annexb(path: str, frames, fps: float = 30.0) -> str:
    """Write an .h264 elementary stream file; returns the path.
    (Raw Annex-B carries no timing — fps is advisory for callers.)"""
    data = encode_frames(frames)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


# ----------------------------------------------------- I_PCM fast decode

class _BitReader:
    def __init__(self, data: bytes):
        self._d = data
        self.pos = 0               # bit position

    def u(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self._d[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad Exp-Golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _unescape(rbsp: bytes) -> bytes:
    """Inverse of emulation prevention: 00 00 03 → 00 00.
    Left-to-right non-overlapping replace is the exact inverse of the
    escaper's left-to-right insertion."""
    return rbsp.replace(b"\x00\x00\x03", b"\x00\x00")


def decode_ipcm_au(au: bytes) -> "np.ndarray | None":
    """From-scratch decoder for the intra-only I_PCM streams THIS
    module emits (every MB is ``mb_type 25``, so the slice body is a
    deterministic 2-byte-header + 384-byte-payload lattice that numpy
    can lift in one stride pass — no per-MB Python loop).

    The only general H.264 decoder at hand is cv2's bundled FFmpeg
    behind a per-AU temp-file open (``demux._decode_h264_au``), and the
    card's machine has none. Returns BGR [H, W, 3], or None when the AU
    is not this exact dialect (callers fall back to the general shim —
    real cameras' CAVLC scans land there)."""
    sps_nal = idr_nal = None
    for nal in split_annexb(au):
        t = nal[0] & 0x1F
        if t == 7:
            sps_nal = nal
        elif t == 5:
            idr_nal = nal
    if sps_nal is None or idr_nal is None:
        return None
    try:
        r = _BitReader(_unescape(sps_nal[1:]))
        if r.u(8) != 66:                   # baseline, as we write it
            return None
        r.u(16)                            # constraint flags + level
        r.ue()                             # sps id
        r.ue()                             # log2_max_frame_num_minus4
        if r.ue() != 2:                    # pic_order_cnt_type
            return None
        r.ue()                             # max_num_ref_frames
        r.u(1)                             # gaps allowed
        mbs_w = r.ue() + 1
        mbs_h = r.ue() + 1
        r.u(1)                             # frame_mbs_only
        r.u(1)                             # direct_8x8
        crop_r = crop_b = 0
        if r.u(1):                         # frame_cropping_flag
            # our encoder only crops right/bottom — any other crop is
            # a foreign stream and must take the general decoder
            if r.ue() != 0:                # left
                return None
            crop_r = r.ue() * 2
            if r.ue() != 0:                # top
                return None
            crop_b = r.ue() * 2

        body = _unescape(idr_nal[1:])
        s = _BitReader(body)
        s.ue()                             # first_mb_in_slice
        if s.ue() != 7:                    # slice_type I (all)
            return None
        s.ue()                             # pps id
        s.u(4)                             # frame_num (log2 max = 4)
        s.ue()                             # idr_pic_id
        s.u(2)                             # no_output + long_term
        s.se()                             # slice_qp_delta
        if s.ue() != 25:                   # first MB must be I_PCM
            return None
        s.align()
        o0 = s.pos >> 3
    except (IndexError, ValueError):
        return None

    n_mbs = mbs_w * mbs_h
    need = o0 + (n_mbs - 1) * 386 + 384
    if len(body) < need:
        return None
    arr = np.frombuffer(body, np.uint8, count=need)
    if n_mbs > 1:
        heads = arr[o0 + 384:need].reshape(n_mbs - 1, 386)[:, :2]
        # every inter-MB header is ue(25)+align = 0x0D 0x00
        if not (np.all(heads[:, 0] == 0x0D)
                and np.all(heads[:, 1] == 0x00)):
            return None
    # the MBs' 386-byte lattice (the last one's 2-byte header past the
    # end left unset): each row's first 384 bytes are its samples
    lattice = np.empty(n_mbs * 386, np.uint8)
    lattice[:need - o0] = arr[o0:need]
    payload = lattice.reshape(n_mbs, 386)[:, :384]
    y = (payload[:, :256].reshape(mbs_h, mbs_w, 16, 16)
         .transpose(0, 2, 1, 3).reshape(mbs_h * 16, mbs_w * 16))
    u = (payload[:, 256:320].reshape(mbs_h, mbs_w, 8, 8)
         .transpose(0, 2, 1, 3).reshape(mbs_h * 8, mbs_w * 8))
    v = (payload[:, 320:].reshape(mbs_h, mbs_w, 8, 8)
         .transpose(0, 2, 1, 3).reshape(mbs_h * 8, mbs_w * 8))
    ch, cw = mbs_h * 16 - crop_b, mbs_w * 16 - crop_r
    if ch <= 0 or cw <= 0:
        return None          # nonsense crop: not our dialect
    return np.ascontiguousarray(native.i420_to_bgr(y, u, v)[:ch, :cw])


# ------------------------------------------------- RFC 6184 (H.264/RTP)

def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B buffer into raw NAL units (start codes
    stripped). Accepts 3- and 4-byte start codes. Scans with
    ``bytes.find`` — emulation prevention guarantees no start code
    inside a NAL payload, and a byte-by-byte Python loop costs
    ~700 ms on a 3 MB 1080p I_PCM access unit."""
    return list(iter_annexb(data))


def iter_annexb(data) -> Iterator[bytes]:
    """:func:`split_annexb` one NAL unit at a time, over anything with
    ``find`` and slicing (``bytes``, or an ``mmap`` of a long file,
    which is then never copied whole)."""
    i = data.find(b"\x00\x00\x01")
    if i < 0:
        return
    pos = i + 3
    while True:
        j = data.find(b"\x00\x00\x01", pos)
        if j < 0:
            if pos < len(data):
                yield data[pos:]
            return
        end = j
        # a 4-byte start code (00 00 00 01) leaves one zero before
        # the match; RBSP trailing bits keep real NAL tails nonzero
        if end > pos and data[end - 1] == 0:
            end -= 1
        if end > pos:
            yield data[pos:end]
        pos = j + 3


_RTP_HEADER = struct.Struct(">BBHII")


def packetize_rfc6184(access_unit: bytes, seq: int, timestamp: int,
                      ssrc: int, pt: int = 96,
                      mtu: int = 1400) -> tuple[list[bytes], int]:
    """RFC 6184 packetization-mode 1: one Annex-B access unit →
    RTP packets (single NAL unit packets, FU-A fragmentation for
    NALs over the MTU). Marker set on the AU's last packet.
    Returns (packets, next_seq)."""
    nals = split_annexb(access_unit)
    packets: list[bytes] = []
    ts = timestamp & 0xFFFFFFFF
    head = _RTP_HEADER.pack

    for k, nal in enumerate(nals):
        last_nal = k == len(nals) - 1
        if len(nal) <= mtu:
            packets.append(head(0x80, (0x80 if last_nal else 0) | pt,
                                seq & 0xFFFF, ts, ssrc) + nal)
            seq += 1
            continue
        # FU-A (§5.8): indicator carries NRI+type 28; header carries
        # S/E bits + original NAL type
        indicator = (nal[0] & 0x60) | 28
        nal_type = nal[0] & 0x1F
        body = memoryview(nal)[1:]
        offsets = range(0, len(body), mtu)
        last = len(offsets) - 1
        # the FU indicator and header of the middle fragments, and of
        # the first and the last
        middle = bytes([indicator, nal_type])
        for i, off in enumerate(offsets):
            if 0 < i < last:
                fu, marker = middle, 0
            else:
                fu = bytes([indicator, (0x80 if i == 0 else 0)
                            | (0x40 if i == last else 0) | nal_type])
                marker = 0x80 if last_nal and i == last else 0
            packets.append(b"".join((head(0x80, marker | pt, seq & 0xFFFF,
                                          ts, ssrc), fu,
                                     body[off:off + mtu])))
            seq += 1
    return packets, seq
