"""A software WebRTC viewer: the browser's role in one session.

Built from the package's primitives in the client role: it writes an
SDP offer that pins its own certificate's fingerprint, sends the ICE
connectivity check (signed with the answer's ``ice-pwd``), completes
DTLS as the active side, derives the SRTP receive keys (RFC 5764),
checks every packet's SRTP tag, decrypts and reassembles the VP8
frames by RTP timestamp, and sends SRTCP feedback (NACK, PLI, RR) as a
browser does. ``chip_smoke.py`` drives sessions through it, and the
tests drive it over the reference's primitives too (``modules``).
"""

from __future__ import annotations

import hashlib
import hmac
import re
import socket
import struct
import time
import types

#: the viewer's RTCP sender SSRC and ICE username fragment
SSRC = 0xDEADBEEF
UFRAG = "vu"


def port_modules() -> types.SimpleNamespace:
    from evam_tpu_torch.publish.rtc import dtls, rtcp, session, srtp, stun, vp8

    return types.SimpleNamespace(dtls=dtls, rtcp=rtcp, session=session,
                                 srtp=srtp, stun=stun, vp8=vp8)


class Viewer:
    """One viewer on a UDP socket of ``host``; ``modules`` (a namespace
    of ``dtls``, ``rtcp``, ``session``, ``srtp``, ``stun``, ``vp8``)
    defaults to this package's."""

    def __init__(self, cert_dir: str, modules=None, host: str = "127.0.0.1"):
        self.m = modules or port_modules()
        cert, key, self.fingerprint = self.m.dtls.generate_certificate(
            str(cert_dir))
        self.cli = self.m.dtls.DtlsEndpoint(cert, key, server=False)
        self.host = host
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, 0))
        self.sock.settimeout(0.2)
        self.offer = "\r\n".join([
            "v=0", f"o=- 1 2 IN IP4 {host}", "s=-", "t=0 0",
            "m=video 9 UDP/TLS/RTP/SAVPF 96",
            "a=mid:0", f"a=ice-ufrag:{UFRAG}", "a=ice-pwd:" + "p" * 22,
            f"a=fingerprint:sha-256 {self.fingerprint}", "a=setup:active",
            "a=recvonly", "a=rtcp-mux", "a=rtpmap:96 VP8/90000", ""])
        self.answer: str | None = None
        self.ans: dict = {}
        self.target: tuple[str, int] | None = None
        self.media: list[bytes] = []
        self.arrivals: list[float] = []
        self.rejected = 0
        self._plain: list[bytes | None] = []  # media decrypted so far
        self.srtcp_tx = None
        self._keys = None
        self._roc = 0
        self._s_l: int | None = None

    # ---------------------------------------------------- signalling

    def accept(self, answer_sdp: str) -> None:
        """Take the session's SDP answer: its ICE credentials, and its
        media port on this viewer's host."""
        self.answer = answer_sdp
        self.ans = self.m.session.parse_remote_sdp(answer_sdp)
        port = int(re.search(r"^m=video (\d+)", answer_sdp, re.M).group(1))
        self.target = (self.host, port)

    # ------------------------------------------------------ transport

    def connect(self, timeout: float = 20.0) -> None:
        """ICE check, then the DTLS handshake; raises if it does not
        finish within ``timeout``."""
        stun = self.m.stun
        check = stun.StunMessage(
            stun.BINDING_REQUEST, b"\x22" * 12,
            [(stun.ATTR_USERNAME, f"{self.ans['ufrag']}:{UFRAG}".encode()),
             (stun.ATTR_USE_CANDIDATE, b"")],
        ).build(integrity_key=self.ans["pwd"].encode())
        self.sock.sendto(check, self.target)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self.cli.finished:
            self.cli.handshake_step()
            for d in self.cli.take_datagrams():
                self.sock.sendto(d, self.target)
            self.poll()
        if not self.cli.finished:
            raise TimeoutError("viewer: DTLS handshake did not finish")
        lk, ls, rk, rs = self.cli.srtp_keys()
        self.srtcp_tx = self.m.rtcp.SrtcpSender(lk, ls)
        self._keys = self.m.srtp.derive_keys(rk, rs)

    def poll(self) -> bytes | None:
        """Receive one datagram (0.2 s at most): DTLS goes to the
        endpoint, RTP to ``media``; returns the RTP packet or None."""
        stun = self.m.stun
        try:
            data, _ = self.sock.recvfrom(65536)
        except socket.timeout:
            return None
        if stun.is_stun(data):
            return None
        if stun.is_dtls(data):
            self.cli.put_datagram(data)
            return None
        if len(data) < 12 or 192 <= data[1] <= 223:  # RTCP (RFC 5761)
            return None
        self.media.append(data)
        self.arrivals.append(time.monotonic())
        return data

    def recv_for(self, seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            self.poll()

    # ----------------------------------------------------------- srtp

    def _index(self, seq: int) -> int:
        """RFC 3711 §3.3.1: the packet index from the highest sequence
        number seen and the rollover counter."""
        if self._s_l is None:
            self._s_l = seq
            return seq
        if self._s_l < 32768:
            v = self._roc - 1 if seq - self._s_l > 32768 else self._roc
        else:
            v = self._roc + 1 if self._s_l - 32768 > seq else self._roc
        if v > self._roc:
            self._roc, self._s_l = v, seq
        elif v == self._roc and seq > self._s_l:
            self._s_l = seq
        return (v << 16) | seq

    def decrypt(self, pkt: bytes) -> bytes:
        """Check the SRTP tag and decrypt one packet; raises
        ``ValueError`` on a bad tag."""
        srtp = self.m.srtp
        ck, ak, salt = self._keys
        body, tag = pkt[:-srtp.TAG_LEN], pkt[-srtp.TAG_LEN:]
        seq = struct.unpack("!H", pkt[2:4])[0]
        index = self._index(seq)
        calc = hmac.new(ak, body + struct.pack("!I", index >> 16),
                        hashlib.sha1).digest()[:srtp.TAG_LEN]
        if not hmac.compare_digest(tag, calc):
            raise ValueError("SRTP auth tag mismatch")
        ssrc = struct.unpack("!I", pkt[8:12])[0]
        iv = srtp.packet_iv(salt, ssrc, index)
        ks = srtp._aes_ctr_keystream(ck, iv, len(body) - 12)
        n = len(ks)
        plain = (int.from_bytes(body[12:], "big")
                 ^ int.from_bytes(ks, "big")).to_bytes(n, "big") if n else b""
        return body[:12] + plain

    def frames(self) -> list[tuple[int, bytes]]:
        """(RTP timestamp, VP8 payload) of every complete frame received,
        in arrival order of their first packet; every packet's tag is
        checked once (``rejected`` counts the ones that fail)."""
        for pkt in self.media[len(self._plain):]:
            try:
                self._plain.append(self.decrypt(pkt))
            except ValueError:
                self.rejected += 1
                self._plain.append(None)
        by_ts: dict[int, dict[int, bytes]] = {}
        for plain in self._plain:
            if plain is None:
                continue
            ts = struct.unpack("!I", plain[4:8])[0]
            seq = struct.unpack("!H", plain[2:4])[0]
            by_ts.setdefault(ts, {})[seq] = plain  # a resend is a duplicate
        out = []
        for ts, pkts in by_ts.items():
            seqs = sorted(pkts)
            if seqs[-1] - seqs[0] > 32768:  # wrapped inside the frame
                seqs = sorted(pkts, key=lambda s: (s + 32768) & 0xFFFF)
            chain = [pkts[s] for s in seqs]
            contiguous = all(((b - a) & 0xFFFF) == 1
                             for a, b in zip(seqs, seqs[1:]))
            if not contiguous or not chain[-1][1] & 0x80 \
                    or not chain[0][12] & 0x10:
                continue  # a packet missing: incomplete frame
            try:
                out.append((ts, self.m.vp8.depacketize(chain)))
            except ValueError:
                continue
        return out

    # ------------------------------------------------------- feedback

    def send_feedback(self, rtcp_plain: bytes) -> None:
        self.sock.sendto(self.srtcp_tx.protect(rtcp_plain), self.target)

    def seqs(self) -> list[int]:
        return [struct.unpack("!H", p[2:4])[0] for p in self.media]

    def close(self) -> None:
        self.cli.close()
        self.sock.close()
