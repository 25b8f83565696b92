"""SRTP protection — AES_CM_128_HMAC_SHA1_80 (RFC 3711).

Counterpart of ``evam_tpu/publish/rtc/srtp.py``. The reference takes
AES-CTR from ``cryptography``, which the card's machine lacks; the port
takes it from libcrypto's EVP interface through ctypes
(``openssl.AesCtr``). The bytes are the same.

The SRTP profile every browser offers first in DTLS-SRTP. Implements
the AES-CM key-derivation PRF (§4.3), the AES counter-mode packet
cipher (§4.1.1) and the truncated HMAC-SHA1 authentication tag
(§4.2), for the sender role (the service only publishes media).
Validated against the RFC 3711 appendix-B vectors
(tests/test_rtc.py::TestSrtpVectors, tests/test_torch_rtc.py).
"""

from __future__ import annotations

import hashlib
import hmac
import struct

from evam_tpu_torch.publish.rtc.openssl import AesCtr

KEY_LEN = 16      # AES-128
SALT_LEN = 14     # 112-bit session salt
AUTH_KEY_LEN = 20
TAG_LEN = 10      # HMAC-SHA1 truncated to 80 bits

LABEL_RTP_ENCRYPTION = 0x00
LABEL_RTP_AUTH = 0x01
LABEL_RTP_SALT = 0x02


def _aes_ctr_keystream(key: bytes, iv16: bytes, n: int) -> bytes:
    """n bytes of AES-CM keystream: AES-CTR with the 128-bit counter
    starting at ``iv16`` (low 16 bits are the block counter)."""
    return AesCtr(key).xor(iv16, bytes(n))


def derive_keys(
    master_key: bytes, master_salt: bytes,
    index: int = 0, kdr: int = 0,
    labels: tuple[int, int, int] = (
        LABEL_RTP_ENCRYPTION, LABEL_RTP_AUTH, LABEL_RTP_SALT),
) -> tuple[bytes, bytes, bytes]:
    """RFC 3711 §4.3.1 key derivation → (cipher_key, auth_key, salt).

    ``x = (label || index DIV kdr) XOR master_salt``, then AES-CM
    keystream from ``x * 2^16`` under the master key. ``labels``
    selects the key family: (0,1,2) for SRTP (default), (3,4,5) for
    SRTCP (rtcp.SrtcpSender).
    """
    def prf(label: int, out_len: int) -> bytes:
        div = 0 if kdr == 0 else index // kdr
        key_id = (label << 48) | div  # 56-bit field
        x = int.from_bytes(master_salt, "big") ^ key_id
        iv = (x << 16).to_bytes(16, "big")
        return _aes_ctr_keystream(master_key, iv, out_len)

    enc_label, auth_label, salt_label = labels
    return (
        prf(enc_label, KEY_LEN),
        prf(auth_label, AUTH_KEY_LEN),
        prf(salt_label, SALT_LEN),
    )


def packet_iv(session_salt: bytes, ssrc: int, index: int) -> bytes:
    """§4.1.1: IV = (salt * 2^16) XOR (SSRC * 2^64) XOR (index * 2^16)."""
    v = (
        (int.from_bytes(session_salt, "big") << 16)
        ^ (ssrc << 64)
        ^ (index << 16)
    )
    return v.to_bytes(16, "big")


class SrtpSender:
    """Protect outgoing RTP packets for one SSRC.

    Index tracking is trivial for a sender: we emit monotonically
    increasing sequence numbers, so ROC increments exactly on wrap.
    """

    def __init__(self, master_key: bytes, master_salt: bytes):
        if len(master_key) != KEY_LEN or len(master_salt) != SALT_LEN:
            raise ValueError("AES_CM_128: 16-byte key + 14-byte salt")
        self.cipher_key, self.auth_key, self.salt = derive_keys(
            master_key, master_salt)
        self._ctr = AesCtr(self.cipher_key)
        self.roc = 0
        self._last_seq: int | None = None

    def protect(self, rtp: bytes) -> bytes:
        """RTP packet in → SRTP packet out (payload encrypted in
        place, 80-bit auth tag appended; header stays clear)."""
        if len(rtp) < 12:
            raise ValueError("short RTP packet")
        first, _pt, seq = struct.unpack("!BBH", rtp[:4])
        ssrc = struct.unpack("!I", rtp[8:12])[0]
        cc = first & 0x0F
        x_bit = first & 0x10
        payload_off = 12 + 4 * cc
        if x_bit:
            if len(rtp) < payload_off + 4:
                raise ValueError("truncated extension header")
            ext_words = struct.unpack(
                "!H", rtp[payload_off + 2:payload_off + 4])[0]
            payload_off += 4 + 4 * ext_words

        if self._last_seq is not None and seq < self._last_seq:
            self.roc = (self.roc + 1) & 0xFFFFFFFF
        self._last_seq = seq
        index = (self.roc << 16) | seq

        iv = packet_iv(self.salt, ssrc, index)
        protected = rtp[:payload_off] + self._ctr.xor(iv, rtp[payload_off:])
        tag = hmac.new(
            self.auth_key,
            protected + struct.pack("!I", self.roc),
            hashlib.sha1,
        ).digest()[:TAG_LEN]
        return protected + tag
