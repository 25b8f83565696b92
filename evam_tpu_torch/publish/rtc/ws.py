"""RFC 6455 websockets on stdlib sockets and threads.

The reference's signalling client (``publish/webrtc.py``) and relay
(``tools/signaling_server.py``) stand on the ``websockets`` package and
asyncio; the card's machine has no ``websockets``. This module is the
part of RFC 6455 they use, on ``socket``, ``select`` and ``threading``:

* :func:`connect` — the client's opening handshake (a random
  ``Sec-WebSocket-Key``, the ``Sec-WebSocket-Accept`` checked), ``ws://``
  and ``wss://`` (stdlib ``ssl``);
* :class:`WsServer` — the server's handshake, one thread a connection;
* :class:`WebSocket` — either end of an open connection: text and binary
  messages, masked frames from the client and unmasked from the server
  (§5.3; a frame masked the wrong way closes the connection),
  fragmented messages reassembled on receive, ping answered with pong,
  and the closing handshake. No extension is offered or accepted.

``recv`` waits with ``select`` and never changes the socket's timeout,
so another thread may ``send`` on the same connection meanwhile (sends
hold a lock). One thread receives.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import os
import select
import socket
import ssl
import struct
import threading
import time
from urllib.parse import urlsplit

log = logging.getLogger("evam_tpu_torch.publish.rtc.ws")

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA
#: the largest message either end takes (a frame past it closes the
#: connection with 1009)
MAX_MESSAGE = 16 << 20
#: the opening handshake's budget, and the longest header block read
HANDSHAKE_TIMEOUT_S = 10.0
_MAX_HEADERS = 16 << 10


class ConnectionClosed(Exception):
    """The connection is closed: by a close frame (``code``, ``reason``)
    or lost (1006)."""

    def __init__(self, code: int, reason: str = ""):
        super().__init__(f"websocket closed ({code}{': ' if reason else ''}"
                         f"{reason})")
        self.code = code
        self.reason = reason


class HandshakeError(Exception):
    """The opening handshake failed."""


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a ``Sec-WebSocket-Key`` (§4.2.2)."""
    return base64.b64encode(
        hashlib.sha1((key + GUID).encode()).digest()).decode()


def _mask(data: bytes, key: bytes) -> bytes:
    """XOR with the 4-byte key repeated (§5.3)."""
    n = len(data)
    if not n:
        return b""
    pad = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little")
            ^ int.from_bytes(pad, "little")).to_bytes(n, "little")


def _read_headers(sock, deadline: float) -> tuple[list[str], bytes]:
    """The header block's lines and the bytes after it."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        left = deadline - time.monotonic()
        if left <= 0:
            raise HandshakeError("handshake timed out")
        sock.settimeout(left)
        try:
            chunk = sock.recv(4096)
        except socket.timeout:
            raise HandshakeError("handshake timed out") from None
        if not chunk:
            raise HandshakeError("connection closed during the handshake")
        buf += chunk
        if len(buf) > _MAX_HEADERS:
            raise HandshakeError("handshake headers too long")
    head, rest = buf.split(b"\r\n\r\n", 1)
    return head.decode("latin-1").split("\r\n"), rest


def _header_map(lines: list[str]) -> dict[str, str]:
    out: dict[str, str] = {}
    for line in lines:
        name, sep, value = line.partition(":")
        if sep:
            out[name.strip().lower()] = value.strip()
    return out


class WebSocket:
    """One open connection; ``client`` is this end's role."""

    def __init__(self, sock: socket.socket, client: bool,
                 buffered: bytes = b""):
        self.sock = sock
        self.client = client
        self._buf = bytearray(buffered)
        self._send_lock = threading.Lock()
        self._close_sent = False
        self._frag_op: int | None = None
        self._frags: list[bytes] = []
        self.closed = False
        try:
            self.remote_address = sock.getpeername()
        except OSError:
            self.remote_address = None

    # ---------------------------------------------------------- send

    def send(self, message: str | bytes) -> None:
        """One text (``str``) or binary message, in one frame."""
        if isinstance(message, str):
            self._send_frame(OP_TEXT, message.encode())
        else:
            self._send_frame(OP_BINARY, bytes(message))

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        n = len(payload)
        mask_bit = 0x80 if self.client else 0
        header = bytes([0x80 | opcode])
        if n < 126:
            header += bytes([mask_bit | n])
        elif n < 1 << 16:
            header += bytes([mask_bit | 126]) + struct.pack("!H", n)
        else:
            header += bytes([mask_bit | 127]) + struct.pack("!Q", n)
        if self.client:
            key = os.urandom(4)
            header += key
            payload = _mask(payload, key)
        with self._send_lock:
            if self._close_sent:
                raise ConnectionClosed(1006, "send after close")
            if opcode == OP_CLOSE:
                self._close_sent = True
            try:
                self.sock.sendall(header + payload)
            except OSError as exc:
                self.closed = True
                raise ConnectionClosed(1006, str(exc)) from exc

    # ---------------------------------------------------------- recv

    def recv(self, timeout: float | None = None) -> str | bytes | None:
        """The next message (``str`` for text, ``bytes`` for binary);
        None when ``timeout`` seconds pass first. Answers pings on the
        way. Raises :class:`ConnectionClosed` once the peer closes or
        the connection is lost."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            frame = self._next_frame(deadline)
            if frame is None:
                return None
            fin, opcode, payload = frame
            if opcode == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self._on_close(payload)
            if opcode == OP_CONT:
                if self._frag_op is None:
                    self._fail(1002, "continuation without a message")
                self._frags.append(payload)
            elif opcode in (OP_TEXT, OP_BINARY):
                if self._frag_op is not None:
                    self._fail(1002, "new message inside a fragmented one")
                self._frag_op, self._frags = opcode, [payload]
            else:
                self._fail(1002, f"unknown opcode {opcode:#x}")
            if sum(map(len, self._frags)) > MAX_MESSAGE:
                self._fail(1009, "message too big")
            if fin:
                data, op = b"".join(self._frags), self._frag_op
                self._frag_op, self._frags = None, []
                if op == OP_TEXT:
                    try:
                        return data.decode()
                    except UnicodeDecodeError:
                        self._fail(1007, "text message is not UTF-8")
                return data

    def _on_close(self, payload: bytes) -> None:
        code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 \
            else 1005
        reason = payload[2:].decode("utf-8", "replace")
        if not self._close_sent:
            try:
                self._send_frame(OP_CLOSE, payload[:2])
            except ConnectionClosed:
                pass
        self._drop()
        raise ConnectionClosed(code, reason)

    def _fail(self, code: int, reason: str) -> None:
        try:
            self._send_frame(OP_CLOSE, struct.pack("!H", code)
                             + reason.encode()[:120])
        except ConnectionClosed:
            pass
        self._drop()
        raise ConnectionClosed(code, reason)

    def _next_frame(self, deadline: float | None):
        while True:
            frame = self._parse()
            if frame is not None:
                return frame
            if not self._fill(deadline):
                return None

    def _parse(self):
        b = self._buf
        if len(b) < 2:
            return None
        if b[0] & 0x70:
            self._fail(1002, "reserved bits set (no extension was agreed)")
        fin, opcode = bool(b[0] & 0x80), b[0] & 0x0F
        masked, n, pos = bool(b[1] & 0x80), b[1] & 0x7F, 2
        if n == 126:
            if len(b) < 4:
                return None
            n, pos = struct.unpack("!H", b[2:4])[0], 4
        elif n == 127:
            if len(b) < 10:
                return None
            n, pos = struct.unpack("!Q", b[2:10])[0], 10
        if masked == self.client:
            self._fail(1002, "frame masked the wrong way for this end")
        if n > MAX_MESSAGE:
            self._fail(1009, "frame too big")
        if opcode >= 0x8 and (n > 125 or not fin):
            self._fail(1002, "bad control frame")
        key = b""
        if masked:
            if len(b) < pos + 4:
                return None
            key, pos = bytes(b[pos:pos + 4]), pos + 4
        if len(b) < pos + n:
            return None
        payload = bytes(b[pos:pos + n])
        del b[:pos + n]
        return fin, opcode, _mask(payload, key) if masked else payload

    def _fill(self, deadline: float | None) -> bool:
        """Read what the socket has into the buffer; False when the
        deadline passes first."""
        if self.closed:
            raise ConnectionClosed(1006, "connection closed")
        pending = isinstance(self.sock, ssl.SSLSocket) and self.sock.pending()
        if not pending:
            wait = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            try:
                ready, _, _ = select.select([self.sock], [], [], wait)
            except (OSError, ValueError) as exc:  # closed under us
                self._drop()
                raise ConnectionClosed(1006, str(exc)) from exc
            if not ready:
                return False
        try:
            data = self.sock.recv(1 << 16)
        except ssl.SSLWantReadError:
            return True  # a TLS record still incomplete: wait again
        except OSError as exc:
            self._drop()
            raise ConnectionClosed(1006, str(exc)) from exc
        if not data:
            self._drop()
            raise ConnectionClosed(1006, "connection lost")
        self._buf += data
        return True

    # --------------------------------------------------------- close

    def close(self, code: int = 1000, reason: str = "") -> None:
        """Send a close frame (once) and close the socket; a thread
        blocked in ``recv`` wakes with :class:`ConnectionClosed`."""
        if not self._close_sent and not self.closed:
            try:
                self._send_frame(OP_CLOSE, struct.pack("!H", code)
                                 + reason.encode()[:120])
            except ConnectionClosed:
                pass
        self._drop()

    def _drop(self) -> None:
        self.closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def connect(url: str, timeout: float = HANDSHAKE_TIMEOUT_S) -> WebSocket:
    """Open a client connection to ``ws://host:port/path`` (or
    ``wss://``). Raises :class:`HandshakeError` or ``OSError``."""
    parts = urlsplit(url)
    if parts.scheme not in ("ws", "wss") or not parts.hostname:
        raise ValueError(f"not a ws:// or wss:// URL: {url!r}")
    secure = parts.scheme == "wss"
    host = parts.hostname
    port = parts.port or (443 if secure else 80)
    path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    deadline = time.monotonic() + timeout
    sock = socket.create_connection((host, port), timeout)
    try:
        if secure:
            sock = ssl.create_default_context().wrap_socket(
                sock, server_hostname=host)
        key = base64.b64encode(os.urandom(16)).decode()
        host_header = host if ":" not in host else f"[{host}]"
        if parts.port:
            host_header += f":{port}"
        sock.sendall((
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {host_header}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        lines, rest = _read_headers(sock, deadline)
        status = lines[0].split(" ", 2)
        headers = _header_map(lines[1:])
        if len(status) < 2 or status[1] != "101":
            raise HandshakeError(f"server answered {lines[0]!r}")
        if headers.get("upgrade", "").lower() != "websocket" or \
                "upgrade" not in headers.get("connection", "").lower():
            raise HandshakeError("server did not upgrade to websocket")
        if headers.get("sec-websocket-accept") != accept_key(key):
            raise HandshakeError("Sec-WebSocket-Accept does not match the key")
        if headers.get("sec-websocket-extensions"):
            raise HandshakeError("server chose an extension none was offered")
        sock.settimeout(None)
        return WebSocket(sock, client=True, buffered=rest)
    except BaseException:
        sock.close()
        raise


class WsServer:
    """Accept websocket connections on ``host:port`` (0: any free port)
    and run ``handler(ws)`` for each on a thread of its own; the
    connection closes when the handler returns."""

    def __init__(self, host: str, port: int, handler):
        self.host = host
        self.handler = handler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._conns: set[WebSocket] = set()
        self._threads: list[threading.Thread] = []
        self._thread: threading.Thread | None = None

    def start(self) -> "WsServer":
        self._thread = threading.Thread(target=self._accept_loop,
                                        name=f"ws-accept-{self.port}",
                                        daemon=True)
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listening socket closed by stop()
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name=f"ws-conn-{self.port}", daemon=True)
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            ws = self._handshake(conn)
        except (HandshakeError, OSError) as exc:
            log.debug("websocket handshake refused: %s", exc)
            conn.close()
            return
        with self._lock:
            if self._stop.is_set():
                ws.close(1001)
                return
            self._conns.add(ws)
        try:
            self.handler(ws)
        except ConnectionClosed:
            pass
        except Exception:  # noqa: BLE001 — one connection, not the server
            log.exception("websocket handler failed")
        finally:
            with self._lock:
                self._conns.discard(ws)
            ws.close()

    @staticmethod
    def _handshake(conn: socket.socket) -> WebSocket:
        lines, rest = _read_headers(conn, time.monotonic() + HANDSHAKE_TIMEOUT_S)
        request = lines[0].split(" ")
        headers = _header_map(lines[1:])
        key = headers.get("sec-websocket-key", "")
        try:
            nonce = base64.b64decode(key, validate=True)
        except ValueError:
            nonce = b""
        ok = (len(request) == 3 and request[0] == "GET"
              and headers.get("upgrade", "").lower() == "websocket"
              and "upgrade" in headers.get("connection", "").lower()
              and headers.get("sec-websocket-version") == "13"
              and len(nonce) == 16)
        if not ok:
            conn.sendall(b"HTTP/1.1 400 Bad Request\r\n"
                         b"Content-Length: 0\r\nConnection: close\r\n\r\n")
            raise HandshakeError(f"not a websocket upgrade: {lines[0]!r}")
        conn.sendall((
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n").encode())
        conn.settimeout(None)
        return WebSocket(conn, client=False, buffered=rest)

    def stop(self) -> None:
        """Stop accepting, close every connection (1001) and wait for
        the handlers."""
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        with self._lock:
            conns, threads = list(self._conns), list(self._threads)
        for ws in conns:
            ws.close(1001)
        if self._thread is not None:
            self._thread.join(timeout=5)
        for t in threads:
            t.join(timeout=5)
