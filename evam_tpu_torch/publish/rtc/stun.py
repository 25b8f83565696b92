"""STUN (RFC 5389) message codec + ICE-lite responder role.

Counterpart of ``evam_tpu/publish/rtc/stun.py``, unchanged: it needs
only the standard library.

Just enough of STUN for WebRTC connectivity checks: BINDING
request/success-response with USERNAME, MESSAGE-INTEGRITY (HMAC-SHA1,
short-term credentials = the ICE password), FINGERPRINT, and
XOR-MAPPED-ADDRESS. The server side is ICE-lite (RFC 8445 §2.5): it
never initiates checks, it answers the browser's and watches for
USE-CANDIDATE to nominate the pair.

Validated against the RFC 5769 sample messages
(tests/test_rtc.py::TestStunVectors, tests/test_torch_rtc.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import os
import socket
import struct
import zlib

MAGIC_COOKIE = 0x2112A442
HEADER_LEN = 20

BINDING_REQUEST = 0x0001
BINDING_SUCCESS = 0x0101
BINDING_ERROR = 0x0111

ATTR_MAPPED_ADDRESS = 0x0001
ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_ERROR_CODE = 0x0009
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_SOFTWARE = 0x8022
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A

FINGERPRINT_XOR = 0x5354554E  # "STUN"


def _pad4(n: int) -> int:
    return (n + 3) & ~3


@dataclasses.dataclass
class StunMessage:
    msg_type: int
    transaction_id: bytes  # 12 bytes
    attributes: list[tuple[int, bytes]]

    @classmethod
    def parse(cls, data: bytes) -> "StunMessage":
        if len(data) < HEADER_LEN:
            raise ValueError("short STUN message")
        msg_type, length, cookie = struct.unpack("!HHI", data[:8])
        if cookie != MAGIC_COOKIE:
            raise ValueError("bad magic cookie")
        if msg_type & 0xC000:
            raise ValueError("not a STUN message (first bits set)")
        tid = data[8:20]
        if len(data) < HEADER_LEN + length:
            raise ValueError("truncated STUN message")
        attrs = []
        i = HEADER_LEN
        end = HEADER_LEN + length
        while i + 4 <= end:
            a_type, a_len = struct.unpack("!HH", data[i:i + 4])
            val = data[i + 4:i + 4 + a_len]
            if len(val) != a_len:
                raise ValueError("truncated attribute")
            attrs.append((a_type, val))
            i += 4 + _pad4(a_len)
        return cls(msg_type, tid, attrs)

    def get(self, a_type: int) -> bytes | None:
        for t, v in self.attributes:
            if t == a_type:
                return v
        return None

    # --------------------------------------------------------- build

    def _encode(self, attrs: list[tuple[int, bytes]]) -> bytes:
        body = b""
        for t, v in attrs:
            body += struct.pack("!HH", t, len(v)) + v
            body += b"\x00" * (_pad4(len(v)) - len(v))
        return (
            struct.pack("!HHI", self.msg_type, len(body), MAGIC_COOKIE)
            + self.transaction_id + body
        )

    def build(self, integrity_key: bytes | None = None,
              fingerprint: bool = True) -> bytes:
        """Serialize. RFC 5389 §15.4/.5: each trailer attribute is
        computed over the message that precedes it, with the header
        length field pre-adjusted to include the attribute itself
        (+24 for MESSAGE-INTEGRITY, +8 for FINGERPRINT)."""
        attrs = list(self.attributes)
        msg = self._encode(attrs)

        def adjusted(extra: int) -> bytes:
            return struct.pack(
                "!HH", self.msg_type, len(msg) - HEADER_LEN + extra
            ) + msg[4:HEADER_LEN] + msg[HEADER_LEN:]

        if integrity_key is not None:
            mac = hmac.new(
                integrity_key, adjusted(24), hashlib.sha1).digest()
            attrs.append((ATTR_MESSAGE_INTEGRITY, mac))
            msg = self._encode(attrs)
        if fingerprint:
            crc = (zlib.crc32(adjusted(8)) & 0xFFFFFFFF) ^ FINGERPRINT_XOR
            attrs.append((ATTR_FINGERPRINT, struct.pack("!I", crc)))
            msg = self._encode(attrs)
        return msg

    # ----------------------------------------------------- integrity

    def check_integrity(self, raw: bytes, key: bytes) -> bool:
        """Verify MESSAGE-INTEGRITY on a received message (RFC 5389
        §15.4: HMAC over the message up to the attribute, with the
        length field covering through it)."""
        i = HEADER_LEN
        length = struct.unpack("!H", raw[2:4])[0]
        end = HEADER_LEN + length
        while i + 4 <= end:
            a_type, a_len = struct.unpack("!HH", raw[i:i + 4])
            if a_type == ATTR_MESSAGE_INTEGRITY:
                mac = raw[i + 4:i + 24]
                adj = raw[:2] + struct.pack(
                    "!H", i + 24 - HEADER_LEN) + raw[4:HEADER_LEN]
                calc = hmac.new(
                    key, adj + raw[HEADER_LEN:i], hashlib.sha1).digest()
                return hmac.compare_digest(mac, calc)
            i += 4 + _pad4(a_len)
        return False


def check_fingerprint(raw: bytes) -> bool:
    """Verify the trailing FINGERPRINT attribute (RFC 5389 §15.5)."""
    length = struct.unpack("!H", raw[2:4])[0]
    i = HEADER_LEN
    end = HEADER_LEN + length
    while i + 4 <= end:
        a_type, a_len = struct.unpack("!HH", raw[i:i + 4])
        if a_type == ATTR_FINGERPRINT:
            want = struct.unpack("!I", raw[i + 4:i + 8])[0]
            adj = raw[:2] + struct.pack(
                "!H", i + 8 - HEADER_LEN) + raw[4:HEADER_LEN]
            crc = (zlib.crc32(adj + raw[HEADER_LEN:i]) & 0xFFFFFFFF) \
                ^ FINGERPRINT_XOR
            return crc == want
        i += 4 + _pad4(a_len)
    return False


def xor_mapped_address(addr: tuple[str, int],
                       transaction_id: bytes) -> bytes:
    """Encode an (ip, port) as XOR-MAPPED-ADDRESS (v4/v6)."""
    ip, port = addr
    xport = port ^ (MAGIC_COOKIE >> 16)
    try:
        packed = socket.inet_aton(ip)
        fam = 0x01
        xip = bytes(
            b ^ k for b, k in zip(packed, struct.pack("!I", MAGIC_COOKIE)))
    except OSError:
        packed = socket.inet_pton(socket.AF_INET6, ip)
        fam = 0x02
        key = struct.pack("!I", MAGIC_COOKIE) + transaction_id
        xip = bytes(b ^ k for b, k in zip(packed, key))
    return struct.pack("!BBH", 0, fam, xport) + xip


def is_stun(datagram: bytes) -> bool:
    """Demultiplex STUN from SRTP/DTLS on the shared media socket
    (RFC 7983): STUN starts 0x00-0x03 + magic cookie."""
    return (
        len(datagram) >= HEADER_LEN
        and datagram[0] < 4
        and struct.unpack("!I", datagram[4:8])[0] == MAGIC_COOKIE
    )


def is_dtls(datagram: bytes) -> bool:
    """RFC 7983: DTLS record content types live in [20, 63]."""
    return len(datagram) > 0 and 20 <= datagram[0] <= 63


class IceLiteResponder:
    """Answer ICE connectivity checks on the media socket.

    ``local_pwd`` authenticates incoming checks (the browser signs
    with OUR password); responses are signed with it too. Tracks the
    peer's source address once a valid check arrives (that is the
    candidate pair for an ice-lite host candidate) and whether
    USE-CANDIDATE nominated us.
    """

    def __init__(self, local_ufrag: str | None = None,
                 local_pwd: str | None = None):
        self.local_ufrag = local_ufrag or os.urandom(3).hex()
        # ice-pwd must be >= 22 chars (RFC 8445 §5.3)
        self.local_pwd = local_pwd or os.urandom(12).hex()
        self.remote_addr: tuple[str, int] | None = None
        self.nominated = False

    def handle(self, datagram: bytes,
               addr: tuple[str, int]) -> bytes | None:
        """Process one STUN datagram; returns the response to send
        (or None for non-requests/invalid)."""
        try:
            msg = StunMessage.parse(datagram)
        except ValueError:
            return None
        if msg.msg_type != BINDING_REQUEST:
            return None
        key = self.local_pwd.encode()
        # RFC 8445 §7.2.2: connectivity checks MUST carry
        # MESSAGE-INTEGRITY over our password — an unauthenticated
        # request must never repoint the media destination
        if not msg.check_integrity(datagram, key):
            return None  # absent or bad credentials: drop silently
        self.remote_addr = addr
        if msg.get(ATTR_USE_CANDIDATE) is not None:
            self.nominated = True
        resp = StunMessage(
            BINDING_SUCCESS, msg.transaction_id,
            [(ATTR_XOR_MAPPED_ADDRESS,
              xor_mapped_address(addr, msg.transaction_id))],
        )
        return resp.build(integrity_key=key)
