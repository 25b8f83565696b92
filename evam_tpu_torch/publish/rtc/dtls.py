"""DTLS 1.2 + use_srtp via ctypes over the system OpenSSL 3.

Counterpart of ``evam_tpu/publish/rtc/dtls.py``: the same endpoint over
the libraries ``openssl.py`` loads. One change: the reference makes its
certificate with the ``openssl`` CLI (``req`` and ``x509``
subprocesses), which the card's machine may lack; the port makes the
same kind of certificate through libcrypto and writes the same
``cert.pem`` and ``key.pem``.

The image ships ``libssl.so.3``/``libcrypto.so.3`` (no headers, no
pyOpenSSL), so the bindings are declared by hand: memory-BIO DTLS
endpoints (the WebRTC pattern — datagrams are shuttled between the
UDP socket and the BIO pair), the ``use_srtp`` extension negotiating
SRTP_AES128_CM_SHA1_80, and RFC 5764 §4.2 keying-material export
(client/server SRTP master keys + salts).

Certificates are generated at startup (self-signed EC, like every
browser's per-session WebRTC cert) and fingerprinted for the SDP
``a=fingerprint`` line.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import tempfile

from evam_tpu_torch.publish.rtc import openssl

SRTP_PROFILE = "SRTP_AES128_CM_SHA1_80"
EXPORT_LABEL = b"EXTRACTOR-dtls_srtp"
KEY_MATERIAL_LEN = 2 * (16 + 14)  # client+server key(16) + salt(14)

SSL_ERROR_WANT_READ = 2
SSL_ERROR_WANT_WRITE = 3
SSL_FILETYPE_PEM = 1
SSL_VERIFY_PEER = 0x01
SSL_VERIFY_FAIL_IF_NO_PEER_CERT = 0x02
#: the reference's certificate: subject and issuer CN, validity in days
CERT_CN = "evam-tpu"
CERT_DAYS = 30
MBSTRING_ASC = 0x1001

#: verify callback that accepts any chain: WebRTC peers use
#: self-signed per-session certs, so chain verification is
#: meaningless — authentication is the SDP fingerprint pin, checked
#: post-handshake via peer_fingerprint()
_VERIFY_CB_TYPE = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_accept_any_chain = _VERIFY_CB_TYPE(lambda _ok, _ctx: 1)


def _pem(crypto, write, obj, *extra) -> bytes:
    """``write(bio, obj, *extra)`` into a memory BIO → its bytes."""
    bio = crypto.BIO_new(crypto.BIO_s_mem())
    if not bio:
        raise RuntimeError(openssl.error_string("BIO_new"))
    try:
        if write(bio, obj, *extra) != 1:
            raise RuntimeError(openssl.error_string(write.__name__))
        n = int(crypto.BIO_ctrl_pending(bio))
        buf = ctypes.create_string_buffer(n)
        if crypto.BIO_read(bio, buf, n) != n:
            raise RuntimeError(openssl.error_string("BIO_read"))
        return buf.raw
    finally:
        crypto.BIO_free(bio)


def _check(rc: int, where: str) -> None:
    """OpenSSL's 1 for success."""
    if rc != 1:
        raise RuntimeError(openssl.error_string(where))


def _nonnull(ptr, where: str):
    if not ptr:
        raise RuntimeError(openssl.error_string(where))
    return ptr


def _self_signed(crypto) -> tuple[bytes, bytes]:
    """A new P-256 key and its self-signed certificate (CN=evam-tpu,
    30 days, SHA-256) → (cert PEM, PKCS#8 key PEM): what ``openssl req
    -x509 -newkey ec -pkeyopt ec_paramgen_curve:prime256v1 -days 30
    -nodes -subj /CN=evam-tpu`` writes. The keygen goes through
    ``EVP_PKEY_CTX_new_from_name``, not the variadic
    ``EVP_PKEY_Q_keygen`` / ``EVP_EC_gen``."""
    pkey = ctypes.c_void_p()
    kctx = _nonnull(crypto.EVP_PKEY_CTX_new_from_name(None, b"EC", None),
                    "EVP_PKEY_CTX_new_from_name")
    try:
        _check(crypto.EVP_PKEY_keygen_init(kctx), "EVP_PKEY_keygen_init")
        _check(crypto.EVP_PKEY_CTX_set_group_name(kctx, b"P-256"),
               "EVP_PKEY_CTX_set_group_name")
        _check(crypto.EVP_PKEY_generate(kctx, ctypes.byref(pkey)),
               "EVP_PKEY_generate")
    finally:
        crypto.EVP_PKEY_CTX_free(kctx)
    x509 = None
    try:
        x509 = _nonnull(crypto.X509_new(), "X509_new")
        _check(crypto.X509_set_version(x509, 2), "X509_set_version")  # v3
        _check(crypto.ASN1_INTEGER_set(
            crypto.X509_get_serialNumber(x509),
            int.from_bytes(os.urandom(4), "big") & 0x7FFFFFFF),
            "ASN1_INTEGER_set")
        _nonnull(crypto.X509_gmtime_adj(crypto.X509_getm_notBefore(x509), 0),
                 "X509_gmtime_adj")
        _nonnull(crypto.X509_gmtime_adj(crypto.X509_getm_notAfter(x509),
                                        CERT_DAYS * 86400), "X509_gmtime_adj")
        _check(crypto.X509_set_pubkey(x509, pkey), "X509_set_pubkey")
        name = _nonnull(crypto.X509_get_subject_name(x509),
                        "X509_get_subject_name")
        _check(crypto.X509_NAME_add_entry_by_txt(
            name, b"CN", MBSTRING_ASC, CERT_CN.encode(), -1, -1, 0),
            "X509_NAME_add_entry_by_txt")
        _check(crypto.X509_set_issuer_name(x509, name), "X509_set_issuer_name")
        if crypto.X509_sign(x509, pkey, crypto.EVP_sha256()) <= 0:
            raise RuntimeError(openssl.error_string("X509_sign"))
        cert_pem = _pem(crypto, crypto.PEM_write_bio_X509, x509)
        key_pem = _pem(crypto, crypto.PEM_write_bio_PrivateKey, pkey,
                       None, None, 0, None, None)
        return cert_pem, key_pem
    finally:
        if x509:
            crypto.X509_free(x509)
        crypto.EVP_PKEY_free(pkey)


def _fingerprint(der: bytes) -> str:
    digest = hashlib.sha256(der).hexdigest().upper()
    return ":".join(digest[i:i + 2] for i in range(0, len(digest), 2))


def _cert_der(crypto, cert_pem: bytes) -> bytes:
    """The DER of a PEM certificate (``i2d_X509`` of what
    ``SSL_CTX_use_certificate_file`` would load)."""
    bio = crypto.BIO_new(crypto.BIO_s_mem())
    x509 = None
    try:
        crypto.BIO_write(bio, cert_pem, len(cert_pem))
        x509 = crypto.PEM_read_bio_X509(bio, None, None, None)
        if not x509:
            raise RuntimeError(openssl.error_string("PEM_read_bio_X509"))
        return _i2d(crypto, x509)
    finally:
        if x509:
            crypto.X509_free(x509)
        crypto.BIO_free(bio)


def _i2d(crypto, x509) -> bytes:
    n = crypto.i2d_X509(x509, None)
    if n <= 0:
        raise RuntimeError(openssl.error_string("i2d_X509"))
    buf = ctypes.create_string_buffer(n)
    ptr = ctypes.c_void_p(ctypes.addressof(buf))
    crypto.i2d_X509(x509, ctypes.byref(ptr))
    return buf.raw[:n]


def generate_certificate(state_dir: str | None = None) -> tuple[str, str, str]:
    """Self-signed EC cert made through libcrypto →
    (cert_path, key_path, sha256_fingerprint "AB:CD:…"). ``cert.pem``
    and ``key.pem`` in ``state_dir`` are kept and reused, as the
    reference's are; without a ``state_dir`` a new temporary one."""
    crypto = openssl.crypto()
    d = state_dir or tempfile.mkdtemp(prefix="evam_rtc_")
    os.makedirs(d, exist_ok=True)
    cert, key = os.path.join(d, "cert.pem"), os.path.join(d, "key.pem")
    if not (os.path.exists(cert) and os.path.exists(key)):
        cert_pem, key_pem = _self_signed(crypto)
        fd = os.open(key, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(key_pem)
        with open(cert, "wb") as f:
            f.write(cert_pem)
    with open(cert, "rb") as f:
        der = _cert_der(crypto, f.read())
    return cert, key, _fingerprint(der)


class DtlsEndpoint:
    """One memory-BIO DTLS endpoint (server or client role).

    Drive with ``put_datagram`` (network → rbio) and
    ``take_datagrams`` (wbio → network); ``handshake_step`` pumps the
    state machine. After completion, ``srtp_keys()`` returns the
    (local_key, local_salt, remote_key, remote_salt) for our sender
    direction per RFC 5764 §4.2 key layout.
    """

    def __init__(self, cert_path: str, key_path: str,
                 server: bool = True):
        ssl, crypto = openssl.ssl(), openssl.crypto()
        self._ssl_lib, self._crypto = ssl, crypto
        self.server = server
        self.ctx = ssl.SSL_CTX_new(ssl.DTLS_method())
        if not self.ctx:
            raise RuntimeError("SSL_CTX_new failed")
        if ssl.SSL_CTX_use_certificate_file(
                self.ctx, cert_path.encode(), SSL_FILETYPE_PEM) != 1:
            raise RuntimeError(self._err("use_certificate"))
        if ssl.SSL_CTX_use_PrivateKey_file(
                self.ctx, key_path.encode(), SSL_FILETYPE_PEM) != 1:
            raise RuntimeError(self._err("use_privatekey"))
        # 0 = success for this call (inverted vs most OpenSSL APIs)
        if ssl.SSL_CTX_set_tlsext_use_srtp(
                self.ctx, SRTP_PROFILE.encode()) != 0:
            raise RuntimeError(self._err("set_tlsext_use_srtp"))
        # Require a peer certificate (both WebRTC roles present one);
        # any chain is accepted here — the caller pins the SDP
        # fingerprint against peer_fingerprint() after the handshake.
        ssl.SSL_CTX_set_verify(
            self.ctx,
            SSL_VERIFY_PEER | SSL_VERIFY_FAIL_IF_NO_PEER_CERT,
            _accept_any_chain,
        )
        self.conn = ssl.SSL_new(self.ctx)
        self.rbio = crypto.BIO_new(crypto.BIO_s_mem())
        self.wbio = crypto.BIO_new(crypto.BIO_s_mem())
        ssl.SSL_set_bio(self.conn, self.rbio, self.wbio)  # owns BIOs
        if server:
            ssl.SSL_set_accept_state(self.conn)
        else:
            ssl.SSL_set_connect_state(self.conn)

    def _err(self, where: str) -> str:
        return openssl.error_string(where)

    # ------------------------------------------------------ datagrams

    def put_datagram(self, data: bytes) -> None:
        self._crypto.BIO_write(self.rbio, data, len(data))

    def take_datagrams(self) -> list[bytes]:
        out = []
        while True:
            pending = self._crypto.BIO_ctrl_pending(self.wbio)
            if not pending:
                break
            buf = ctypes.create_string_buffer(int(pending))
            n = self._crypto.BIO_read(self.wbio, buf, int(pending))
            if n <= 0:
                break
            out.append(buf.raw[:n])
        return out

    # ------------------------------------------------------ handshake

    def handshake_step(self) -> bool:
        """Advance the handshake; True once complete."""
        ssl = self._ssl_lib
        if ssl.SSL_is_init_finished(self.conn):
            return True
        rc = ssl.SSL_do_handshake(self.conn)
        if rc == 1:
            return True
        err = ssl.SSL_get_error(self.conn, rc)
        if err in (SSL_ERROR_WANT_READ, SSL_ERROR_WANT_WRITE):
            return False
        raise RuntimeError(self._err(f"handshake (SSL_get_error={err})"))

    def handle_timeout(self) -> None:
        """Retransmit a lost flight (call on a ~1 s stall).
        DTLSv1_handle_timeout is a macro: SSL_ctrl(ssl,
        DTLS_CTRL_HANDLE_TIMEOUT=74, 0, NULL)."""
        self._ssl_lib.SSL_ctrl(self.conn, 74, 0, None)

    @property
    def finished(self) -> bool:
        return bool(self._ssl_lib.SSL_is_init_finished(self.conn))

    # ----------------------------------------------------------- srtp

    def selected_srtp_profile(self) -> str | None:
        p = self._ssl_lib.SSL_get_selected_srtp_profile(self.conn)
        return p.contents.name.decode() if p else None

    def peer_fingerprint(self) -> str | None:
        """sha-256 fingerprint of the peer's certificate (DER),
        "AB:CD:…" — compare against the remote SDP's a=fingerprint
        (the ONLY peer authentication in WebRTC's DTLS)."""
        x509 = self._ssl_lib.SSL_get1_peer_certificate(self.conn)
        if not x509:
            return None
        try:
            return _fingerprint(_i2d(self._crypto, x509))
        except RuntimeError:
            return None
        finally:
            self._crypto.X509_free(x509)

    def export_key_material(self) -> bytes:
        buf = ctypes.create_string_buffer(KEY_MATERIAL_LEN)
        rc = self._ssl_lib.SSL_export_keying_material(
            self.conn, buf, KEY_MATERIAL_LEN,
            EXPORT_LABEL, len(EXPORT_LABEL), None, 0, 0)
        if rc != 1:
            raise RuntimeError(self._err("export_keying_material"))
        return buf.raw

    def srtp_keys(self) -> tuple[bytes, bytes, bytes, bytes]:
        """(local_key, local_salt, remote_key, remote_salt) — RFC 5764
        §4.2 layout: client_key | server_key | client_salt |
        server_salt; 'local' is our sending direction."""
        m = self.export_key_material()
        ck, sk = m[0:16], m[16:32]
        cs, ss = m[32:46], m[46:60]
        if self.server:
            return sk, ss, ck, cs
        return ck, cs, sk, ss

    def close(self) -> None:
        if getattr(self, "conn", None):
            self._ssl_lib.SSL_free(self.conn)
            self.conn = None
        if getattr(self, "ctx", None):
            self._ssl_lib.SSL_CTX_free(self.ctx)
            self.ctx = None

    def __del__(self):  # noqa: D105 — best-effort native cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
