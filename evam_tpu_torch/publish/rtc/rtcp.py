"""Minimal RTCP for the sendonly media session (RFC 3550).

Counterpart of ``evam_tpu/publish/rtc/rtcp.py``: the same packets and
rules, with SRTCP's AES-CTR from libcrypto (``openssl.AesCtr``, as in
``srtp.py``) instead of ``cryptography``.

Browsers use the Sender Report's NTP↔RTP timestamp mapping for A/V
sync and stats, and the SDES CNAME to bind the SSRC to a source.
One compound packet (SR + SDES) every few seconds is enough for a
sendonly video session; it is SRTCP-protected by the caller with the
same SRTP context family (RFC 3711 §3.4) — here the sender encrypts
with its RTCP index and the E-bit, implemented in
``SrtcpSender``.

The receive direction carries the viewer's feedback — Receiver
Reports (RFC 3550 §6.4.2), transport-layer Generic NACK (RFC 4585
§6.2.1) and payload-specific PLI / FIR (RFC 4585 §6.3.1, RFC 5104
§4.3.1) — which drive the session's loss recovery: NACKed packets
are retransmitted from the send cache, PLI/FIR (or heavy RR loss)
forces a VP8 keyframe. ``SrtcpReceiver`` unprotects the inbound
compound, ``parse_feedback`` extracts the actionable bits. The
reference delegates all of this to webrtcbin's full stack
(reference docker-compose.yml:51-52)."""

from __future__ import annotations

import hashlib
import hmac
import struct
import time

from evam_tpu_torch.publish.rtc import srtp
from evam_tpu_torch.publish.rtc.openssl import AesCtr

NTP_EPOCH_OFFSET = 2208988800  # 1900 → 1970


def ntp_now() -> tuple[int, int]:
    t = time.time() + NTP_EPOCH_OFFSET
    sec = int(t)
    frac = int((t - sec) * (1 << 32)) & 0xFFFFFFFF
    return sec & 0xFFFFFFFF, frac


def ntp_mid32() -> int:
    """The middle 32 bits of the NTP timestamp (low 16 of seconds,
    high 16 of fraction) — the LSR/DLSR unit of RFC 3550 §6.4.1."""
    sec, frac = ntp_now()
    return ((sec & 0xFFFF) << 16) | (frac >> 16)


def sender_report(ssrc: int, rtp_ts: int, packets: int,
                  octets: int, cname: str = "evam-tpu") -> bytes:
    """Compound SR + SDES(CNAME)."""
    ntp_s, ntp_f = ntp_now()
    sr = struct.pack(
        "!BBHIIIIII",
        0x80,            # V=2, no padding, RC=0
        200,             # PT=SR
        6,               # length in 32-bit words - 1
        ssrc & 0xFFFFFFFF,
        ntp_s, ntp_f,
        rtp_ts & 0xFFFFFFFF,
        packets & 0xFFFFFFFF,
        octets & 0xFFFFFFFF,
    )
    cname_b = cname.encode()
    item = bytes([1, len(cname_b)]) + cname_b  # CNAME item
    chunk = struct.pack("!I", ssrc & 0xFFFFFFFF) + item + b"\x00"
    pad = (4 - len(chunk) % 4) % 4
    chunk += b"\x00" * pad
    sdes = struct.pack(
        "!BBH", 0x81, 202, len(chunk) // 4) + chunk
    return sr + sdes


class SrtcpSender:
    """SRTCP protection (RFC 3711 §3.4) for outgoing compound RTCP.

    Same master secret as the RTP direction but the RTCP key-family
    labels (3/4/5); the 31-bit index + E-bit trail the ciphertext,
    then the 80-bit tag.
    """

    LABEL_RTCP_ENCRYPTION = 0x03
    LABEL_RTCP_AUTH = 0x04
    LABEL_RTCP_SALT = 0x05

    def __init__(self, master_key: bytes, master_salt: bytes):
        self.cipher_key, self.auth_key, self.salt = srtp.derive_keys(
            master_key, master_salt,
            labels=(self.LABEL_RTCP_ENCRYPTION, self.LABEL_RTCP_AUTH,
                    self.LABEL_RTCP_SALT),
        )
        self._ctr = AesCtr(self.cipher_key)
        self.index = 0

    def protect(self, rtcp: bytes) -> bytes:
        ssrc = struct.unpack("!I", rtcp[4:8])[0]
        index = self.index
        self.index = (self.index + 1) & 0x7FFFFFFF
        iv = srtp.packet_iv(self.salt, ssrc, index)
        enc = rtcp[:8] + self._ctr.xor(iv, rtcp[8:])
        trailer = struct.pack("!I", 0x80000000 | index)  # E-bit set
        tag = hmac.new(
            self.auth_key, enc + trailer, hashlib.sha1,
        ).digest()[:srtp.TAG_LEN]
        return enc + trailer + tag


class SrtcpReceiver:
    """SRTCP unprotection for inbound feedback (RFC 3711 §3.4).

    Constructed with the REMOTE side's master key/salt (the browser's
    DTLS client-write family when we are the DTLS server): verify the
    80-bit tag over ciphertext+index, then AES-CM decrypt from byte 8
    using the 31-bit index carried in the trailer.
    """

    #: replay window width (packets behind the highest-seen index
    #: still accepted exactly once) — RFC 3711 recommends >= 64
    REPLAY_WINDOW = 64

    def __init__(self, master_key: bytes, master_salt: bytes):
        self.cipher_key, self.auth_key, self.salt = srtp.derive_keys(
            master_key, master_salt,
            labels=(SrtcpSender.LABEL_RTCP_ENCRYPTION,
                    SrtcpSender.LABEL_RTCP_AUTH,
                    SrtcpSender.LABEL_RTCP_SALT),
        )
        self._ctr = AesCtr(self.cipher_key)
        self._highest_index = -1     # highest authenticated SRTCP index
        self._replay_mask = 0        # bit i = (highest - i) seen

    def _replay_check(self, index: int) -> None:
        """RFC 3711 §3.3.2 replay list over the 31-bit SRTCP index:
        a captured valid compound (e.g. one NACK re-triggering a
        512-packet retransmit burst) must not be accepted twice."""
        if index > self._highest_index:
            return
        delta = self._highest_index - index
        if delta >= self.REPLAY_WINDOW or (self._replay_mask >> delta) & 1:
            raise ValueError("SRTCP replay: index %d already seen" % index)

    def _replay_commit(self, index: int) -> None:
        if index > self._highest_index:
            shift = index - self._highest_index
            # cap the shift: a far jump (peer restart, index desync)
            # must not materialize a 2^31-bit intermediate
            if shift >= self.REPLAY_WINDOW:
                self._replay_mask = 1
            else:
                self._replay_mask = ((self._replay_mask << shift) | 1) \
                    & ((1 << self.REPLAY_WINDOW) - 1)
            self._highest_index = index
        else:
            self._replay_mask |= 1 << (self._highest_index - index)

    def unprotect(self, pkt: bytes) -> bytes:
        """SRTCP packet in → plaintext RTCP compound out.

        Raises ``ValueError`` on a bad tag, a malformed packet, or a
        replayed SRTCP index — callers drop the packet (never act on
        unauthenticated or replayed feedback: a forged or replayed
        NACK burst is a retransmission-amplifier).
        """
        if len(pkt) < 8 + 4 + srtp.TAG_LEN:
            raise ValueError("short SRTCP packet")
        tag = pkt[-srtp.TAG_LEN:]
        body = pkt[:-srtp.TAG_LEN]           # ciphertext + E|index
        calc = hmac.new(
            self.auth_key, body, hashlib.sha1).digest()[:srtp.TAG_LEN]
        if not hmac.compare_digest(tag, calc):
            raise ValueError("SRTCP auth tag mismatch")
        trailer = struct.unpack("!I", body[-4:])[0]
        e_bit, index = trailer >> 31, trailer & 0x7FFFFFFF
        self._replay_check(index)
        self._replay_commit(index)
        enc = body[:-4]
        if not e_bit:
            return enc                        # unencrypted RTCP
        ssrc = struct.unpack("!I", enc[4:8])[0]
        iv = srtp.packet_iv(self.salt, ssrc, index)
        return enc[:8] + self._ctr.xor(iv, enc[8:])


# ------------------------------------------------------------ feedback parse

PT_SR = 200
PT_RR = 201
PT_RTPFB = 205   # transport-layer feedback (FMT 1 = Generic NACK)
PT_PSFB = 206    # payload-specific feedback (FMT 1 = PLI, 4 = FIR)


def parse_feedback(compound: bytes, media_ssrc: int | None = None) -> dict:
    """Walk a plaintext RTCP compound and pull out what the sender
    acts on: ``{"nack": [seq…], "pli": bool, "fir": bool,
    "fraction_lost": float|None, "highest_seq": int|None,
    "jitter": int|None (RTP clock units), "lsr": int|None,
    "dlsr": int|None}`` (the last two in 1/65536 s, RFC 3550
    §6.4.1 — RTT inputs).

    NACK FCI entries are (PID, BLP) pairs (RFC 4585 §6.2.1): PID is a
    lost packet, each set bit i of BLP marks PID+i+1 lost too.

    ``media_ssrc`` (when given) drops feedback messages addressed to
    a different media source — an authenticated peer must not steer
    retransmission/keyframes for an SSRC it is not receiving.
    """
    out: dict = {"nack": [], "pli": False, "fir": False,
                 "fraction_lost": None, "highest_seq": None,
                 "jitter": None, "lsr": None, "dlsr": None}
    i = 0
    while i + 4 <= len(compound):
        first, pt, length_w = struct.unpack(
            "!BBH", compound[i:i + 4])
        if first >> 6 != 2:                  # bad version: stop walking
            break
        fmt = first & 0x1F                   # RC for SR/RR, FMT for FB
        end = i + 4 * (length_w + 1)
        body = compound[i + 8:end]           # after header + sender-ssrc
        want = None if media_ssrc is None else media_ssrc & 0xFFFFFFFF
        if pt == PT_RR and fmt >= 1 and len(body) >= 24:
            # walk all RC report blocks (24 bytes each) and use the
            # one ABOUT our source — a viewer receiving several
            # streams reports them all in one RR, in any order (the
            # loss path forces keyframes; see _handle_feedback)
            for j in range(0, min(fmt, len(body) // 24) * 24, 24):
                block_ssrc = struct.unpack("!I", body[j:j + 4])[0]
                if want is None or block_ssrc == want:
                    out["fraction_lost"] = body[j + 4] / 256.0
                    (out["highest_seq"], out["jitter"], out["lsr"],
                     out["dlsr"]) = struct.unpack(
                        "!IIII", body[j + 8:j + 24])
                    break
        elif pt in (PT_RTPFB, PT_PSFB) and len(body) >= 4:
            fb_media = struct.unpack("!I", body[:4])[0]
            if pt == PT_PSFB and fmt == 4:
                # FIR (RFC 5104 §4.3.1.1): the header media-SSRC
                # SHALL be 0 — the target SSRC rides in each 8-byte
                # FCI entry. Accept header==want for lenient senders.
                fci_ssrcs = [
                    struct.unpack("!I", body[4 + j:8 + j])[0]
                    for j in range(0, max(0, len(body) - 4 - 7), 8)
                ]
                if (want is None or fb_media == want
                        or want in fci_ssrcs):
                    out["fir"] = True
                i = end
                continue
            if want is not None and fb_media != want:
                i = end
                continue                     # feedback for another source
            if pt == PT_RTPFB and fmt == 1:
                fci = body[4:]
                for j in range(0, len(fci) - 3, 4):
                    pid, blp = struct.unpack("!HH", fci[j:j + 4])
                    out["nack"].append(pid)
                    for bit in range(16):
                        if blp & (1 << bit):
                            out["nack"].append((pid + bit + 1) & 0xFFFF)
            elif pt == PT_PSFB and fmt == 1:
                out["pli"] = True
        i = end
    return out


# ----------------------------------------------- feedback builders (viewer)

def receiver_report(sender_ssrc: int, media_ssrc: int,
                    fraction_lost: float, cumulative_lost: int,
                    highest_seq: int, jitter: int = 0,
                    lsr: int = 0, dlsr: int = 0) -> bytes:
    """RR with one report block — the packet a receiving peer sends;
    here it is the test viewer's way to exercise RR-driven recovery.
    ``jitter`` is in RTP clock units; ``lsr``/``dlsr`` echo the last
    SR per RFC 3550 §6.4.1 (the sender derives RTT from them)."""
    fl = min(255, max(0, int(fraction_lost * 256)))
    return struct.pack(
        "!BBHI I BBH IIII",
        0x81, PT_RR, 7, sender_ssrc & 0xFFFFFFFF,
        media_ssrc & 0xFFFFFFFF,
        fl, (cumulative_lost >> 16) & 0xFF, cumulative_lost & 0xFFFF,
        highest_seq & 0xFFFFFFFF,
        jitter & 0xFFFFFFFF, lsr & 0xFFFFFFFF, dlsr & 0xFFFFFFFF,
    )


def generic_nack(sender_ssrc: int, media_ssrc: int,
                 seqs: list[int]) -> bytes:
    """Generic NACK (RFC 4585 §6.2.1) covering ``seqs`` with packed
    (PID, BLP) FCI entries."""
    seqs = sorted(set(s & 0xFFFF for s in seqs))
    fci = b""
    while seqs:
        pid = seqs.pop(0)
        blp = 0
        rest = []
        for s in seqs:
            d = (s - pid) & 0xFFFF
            if 1 <= d <= 16:
                blp |= 1 << (d - 1)
            else:
                rest.append(s)
        seqs = rest
        fci += struct.pack("!HH", pid, blp)
    hdr = struct.pack(
        "!BBHII", 0x80 | 1, PT_RTPFB, 2 + len(fci) // 4,
        sender_ssrc & 0xFFFFFFFF, media_ssrc & 0xFFFFFFFF)
    return hdr + fci


def pli(sender_ssrc: int, media_ssrc: int) -> bytes:
    """Picture Loss Indication (RFC 4585 §6.3.1) — no FCI."""
    return struct.pack(
        "!BBHII", 0x80 | 1, PT_PSFB, 2,
        sender_ssrc & 0xFFFFFFFF, media_ssrc & 0xFFFFFFFF)
