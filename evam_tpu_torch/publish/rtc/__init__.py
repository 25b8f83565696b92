"""The WebRTC media plane, on what the card's machine has.

Counterpart of ``evam_tpu/publish/rtc/``, built as the reference's was
from the RFCs, but on Python 3.12, numpy, g++ and the system's libssl
and libcrypto (through ctypes) alone: the card's machine has no cv2, no
``cryptography`` and no ``websockets``.

* ``stun``      — RFC 5389 STUN and the ICE-lite responder (RFC 8445).
* ``openssl``   — libssl and libcrypto, loaded once, their functions
  declared by hand (no headers, no pyOpenSSL).
* ``srtp``      — AES_CM_128_HMAC_SHA1_80 (RFC 3711), the AES-128-CTR
  keystream from libcrypto's EVP interface.
* ``rtcp``      — sender and receiver reports, SRTCP both ways with the
  replay window, NACK / PLI / FIR (RFC 3550, 4585, 5104).
* ``dtls``      — DTLS 1.2 with ``use_srtp`` in memory BIOs (RFC 5764);
  the self-signed P-256 certificate made through libcrypto.
* ``vp8``       — the port's VP8 encoder (``csrc/evam_vp8.cpp``) and
  RFC 7741 payloading.
* ``session``   — one viewer: UDP host candidate, ICE answer, DTLS
  handshake, SRTP-protected VP8 sender with NACK / PLI / RR feedback.
* ``ws``        — RFC 6455 websocket client and server on stdlib sockets.
* ``signaling`` — the signalling relay of ``tools/signaling_server.py``
  on ``ws`` (``python -m evam_tpu_torch.publish.rtc.signaling``).
"""

from evam_tpu_torch.publish.rtc.stun import StunMessage  # noqa: F401
