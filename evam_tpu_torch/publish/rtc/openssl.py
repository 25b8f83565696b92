"""libssl and libcrypto through ctypes, loaded once for the package.

The card's machine has the system's OpenSSL 3 (``libssl.so.3``,
``libcrypto.so.3``, which Python's own ``ssl`` module links) but neither
its headers nor ``cryptography`` nor pyOpenSSL, so every function the
media plane calls is declared here by hand: the DTLS endpoint and the
certificate of ``dtls.py``, and the AES-128-CTR keystream of
``srtp.py`` and ``rtcp.py``. The reference loads them in its
``dtls.py`` and takes AES from ``cryptography``.

Where a library cannot be found or lacks a function, the first call
raises ``RuntimeError`` naming it; there is no fallback.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

P = ctypes.c_void_p
_INT = ctypes.c_int
_STR = ctypes.c_char_p


class SrtpProtectionProfile(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p), ("id", ctypes.c_ulong)]


#: name → (argtypes, restype)
CRYPTO_FUNCTIONS = {
    # the AES-128-CTR keystream (srtp.py, rtcp.py)
    "EVP_CIPHER_CTX_new": ([], P),
    "EVP_CIPHER_CTX_free": ([P], None),
    "EVP_aes_128_ctr": ([], P),
    "EVP_EncryptInit_ex": ([P, P, P, _STR, _STR], _INT),
    "EVP_EncryptUpdate": ([P, _STR, ctypes.POINTER(_INT), _STR, _INT], _INT),
    # the self-signed P-256 certificate (dtls.py)
    "EVP_PKEY_CTX_new_from_name": ([P, _STR, _STR], P),
    "EVP_PKEY_keygen_init": ([P], _INT),
    "EVP_PKEY_CTX_set_group_name": ([P, _STR], _INT),
    "EVP_PKEY_generate": ([P, ctypes.POINTER(P)], _INT),
    "EVP_PKEY_CTX_free": ([P], None),
    "EVP_PKEY_free": ([P], None),
    "EVP_sha256": ([], P),
    "X509_new": ([], P),
    "X509_free": ([P], None),
    "X509_set_version": ([P, ctypes.c_long], _INT),
    "X509_get_serialNumber": ([P], P),
    "ASN1_INTEGER_set": ([P, ctypes.c_long], _INT),
    "X509_getm_notBefore": ([P], P),
    "X509_getm_notAfter": ([P], P),
    "X509_gmtime_adj": ([P, ctypes.c_long], P),
    "X509_set_pubkey": ([P, P], _INT),
    "X509_get_subject_name": ([P], P),
    "X509_NAME_add_entry_by_txt": ([P, _STR, _INT, _STR, _INT, _INT, _INT],
                                   _INT),
    "X509_set_issuer_name": ([P, P], _INT),
    "X509_sign": ([P, P, P], _INT),
    "PEM_write_bio_X509": ([P, P], _INT),
    "PEM_write_bio_PrivateKey": ([P, P, P, _STR, _INT, P, P], _INT),
    "i2d_X509": ([P, ctypes.POINTER(P)], _INT),
    "PEM_read_bio_X509": ([P, P, P, P], P),
    # memory BIOs and errors
    "BIO_new": ([P], P),
    "BIO_s_mem": ([], P),
    "BIO_free": ([P], _INT),
    "BIO_read": ([P, _STR, _INT], _INT),
    "BIO_write": ([P, _STR, _INT], _INT),
    "BIO_ctrl_pending": ([P], ctypes.c_size_t),
    "ERR_get_error": ([], ctypes.c_ulong),
    "ERR_error_string_n": ([ctypes.c_ulong, _STR, ctypes.c_size_t], None),
}

SSL_FUNCTIONS = {
    "DTLS_method": ([], P),
    "SSL_CTX_new": ([P], P),
    "SSL_CTX_free": ([P], None),
    "SSL_CTX_use_certificate_file": ([P, _STR, _INT], _INT),
    "SSL_CTX_use_PrivateKey_file": ([P, _STR, _INT], _INT),
    # a function despite its macro-like name
    "SSL_CTX_set_tlsext_use_srtp": ([P, _STR], _INT),
    "SSL_new": ([P], P),
    "SSL_free": ([P], None),
    "SSL_set_bio": ([P, P, P], None),
    "SSL_set_accept_state": ([P], None),
    "SSL_set_connect_state": ([P], None),
    "SSL_do_handshake": ([P], _INT),
    "SSL_get_error": ([P, _INT], _INT),
    "SSL_is_init_finished": ([P], _INT),
    "SSL_export_keying_material": (
        [P, _STR, ctypes.c_size_t, _STR, ctypes.c_size_t, _STR,
         ctypes.c_size_t, _INT], _INT),
    "SSL_get_selected_srtp_profile": (
        [P], ctypes.POINTER(SrtpProtectionProfile)),
    # DTLSv1_handle_timeout and friends are SSL_ctrl macros
    "SSL_ctrl": ([P, _INT, ctypes.c_long, P], ctypes.c_long),
    "SSL_CTX_set_verify": ([P, _INT, P], None),
    "SSL_get1_peer_certificate": ([P], P),
}

#: OpenSSL 3 renamed SSL_get_peer_certificate (1.1) to
#: SSL_get1_peer_certificate (the same up-ref semantics): accept both
_FALLBACKS = {"SSL_get1_peer_certificate": "SSL_get_peer_certificate"}

_lock = threading.Lock()
_crypto: ctypes.CDLL | None = None
_ssl: ctypes.CDLL | None = None
#: "crypto" / "ssl" → the file each was loaded from
loaded: dict[str, str] = {}


def _open(name: str, default: str, mode: int = ctypes.DEFAULT_MODE):
    path = ctypes.util.find_library(name) or default
    try:
        return ctypes.CDLL(path, mode=mode), path
    except OSError as exc:
        raise RuntimeError(
            f"webrtc: lib{name} not found (ctypes.util.find_library("
            f"{name!r}) gave {ctypes.util.find_library(name)!r}, and "
            f"{default} does not load: {exc}); the media plane needs the "
            "system's OpenSSL 3") from exc


def _declare(lib: ctypes.CDLL, table: dict, path: str) -> None:
    for name, (argtypes, restype) in table.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            alt = _FALLBACKS.get(name)
            if alt is None or not hasattr(lib, alt):
                raise RuntimeError(
                    f"webrtc: {path} has no {name} (the media plane needs "
                    "OpenSSL 3)") from None
            fn = getattr(lib, alt)
            setattr(lib, name, fn)
        fn.argtypes = argtypes
        fn.restype = restype


def crypto() -> ctypes.CDLL:
    """libcrypto, loaded (globally, for libssl) and declared once."""
    global _crypto
    with _lock:
        if _crypto is None:
            lib, path = _open("crypto", "libcrypto.so.3", ctypes.RTLD_GLOBAL)
            _declare(lib, CRYPTO_FUNCTIONS, path)
            loaded["crypto"] = path
            _crypto = lib
        return _crypto


def ssl() -> ctypes.CDLL:
    """libssl, loaded and declared once (after libcrypto)."""
    global _ssl
    crypto()
    with _lock:
        if _ssl is None:
            lib, path = _open("ssl", "libssl.so.3")
            _declare(lib, SSL_FUNCTIONS, path)
            loaded["ssl"] = path
            _ssl = lib
        return _ssl


def error_string(where: str) -> str:
    """``where: <the oldest queued OpenSSL error>``."""
    lib = crypto()
    buf = ctypes.create_string_buffer(256)
    lib.ERR_error_string_n(lib.ERR_get_error(), buf, 256)
    return f"{where}: {buf.value.decode()}"


class AesCtr:
    """AES-128 in counter mode under one key: ``xor(iv16, data)`` is
    ``data`` XOR the keystream from the 128-bit counter ``iv16``
    (libcrypto's EVP; the key schedule is kept between calls). One
    thread at a time."""

    def __init__(self, key: bytes):
        self._lib = crypto()
        self._ctx = self._lib.EVP_CIPHER_CTX_new()
        if not self._ctx:
            raise RuntimeError(error_string("EVP_CIPHER_CTX_new"))
        if self._lib.EVP_EncryptInit_ex(self._ctx, self._lib.EVP_aes_128_ctr(),
                                        None, bytes(key), None) != 1:
            raise RuntimeError(error_string("EVP_EncryptInit_ex"))

    def xor(self, iv16: bytes, data: bytes) -> bytes:
        n = len(data)
        if self._lib.EVP_EncryptInit_ex(self._ctx, None, None, None,
                                        bytes(iv16)) != 1:
            raise RuntimeError(error_string("EVP_EncryptInit_ex"))
        out = ctypes.create_string_buffer(n or 1)
        outl = ctypes.c_int()
        if self._lib.EVP_EncryptUpdate(self._ctx, out, ctypes.byref(outl),
                                       bytes(data), n) != 1 or outl.value != n:
            raise RuntimeError(error_string("EVP_EncryptUpdate"))
        return out.raw[:n]

    def __del__(self):
        ctx, self._ctx = getattr(self, "_ctx", None), None
        if ctx:
            self._lib.EVP_CIPHER_CTX_free(ctx)
