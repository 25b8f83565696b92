"""ZeroMQ's wire protocol (ZMTP 3.0) for PUB and SUB sockets, on the
standard library: ``socket``, ``selectors`` and ``threading``.

The reference's message bus (``eii/msgbus.py``) and its ``zmq``
destination speak ZeroMQ through pyzmq. The card's machine has no
pyzmq, so the port speaks the wire itself (RFC 23/ZMTP 3.0) and
interoperates with libzmq's PUB and SUB sockets:

* transports ``tcp://host:port`` (``*`` binds every interface, port
  ``*`` or ``0`` an ephemeral one) and ``ipc://path`` (AF_UNIX; a
  stale socket file is replaced at bind and removed at close, as
  libzmq does); ``bind`` and ``connect`` on either side, a connect
  redialled every ``RECONNECT_IVL_S`` until it succeeds and again after
  its peer goes away;
* the 64-byte greeting (signature ``FF 00…00 7F``, version 3.0,
  mechanism ``NULL``) and the ``READY`` handshake carrying
  ``Socket-Type``, checked against the peer's (PUB talks to SUB and
  XSUB, SUB to PUB and XPUB);
* short and long frames, ``MORE`` and ``COMMAND`` flags; multipart
  messages arrive as a list of ``bytes``;
* subscriptions: a SUB sends each prefix as a message ``01 prefix``
  (``00 prefix`` cancels one), the ZMTP 3.0 form; a PUB accepts that
  form and ZMTP 3.1's ``SUBSCRIBE``/``CANCEL`` commands, counts
  subscriptions per peer and sends a message only to peers with a
  prefix of its first frame; ``PING`` is answered with ``PONG``;
* a send high-water mark per peer: a message for a peer whose queue
  holds ``hwm`` messages is dropped for that peer, and ``send_multipart``
  never blocks (libzmq's PUB drops the same way); a SUB holds at most
  ``hwm`` received messages and drops past that;
* a receive timeout (``rcvtimeo_ms``, libzmq's ``RCVTIMEO``):
  ``recv_multipart`` returns ``None`` when it expires;
* ``close`` discards what is queued (``LINGER 0``) and joins the
  socket's I/O thread.

Each socket runs one I/O thread over non-blocking sockets. Callers
only append to per-peer queues under a lock and wake the thread; the
thread does every read and write, with scatter-gather sends and
partial-write buffers, so a subscriber that stops reading costs drops
at its high-water mark, never a stalled caller.
"""

from __future__ import annotations

import collections
import errno
import itertools
import logging
import os
import queue
import selectors
import socket
import threading
import time
from typing import Callable, Iterable

log = logging.getLogger("evam_tpu_torch.eii.zmtp")

#: frame flags (RFC 23)
MORE, LONG, COMMAND = 0x01, 0x02, 0x04
#: signature, version 3.0, mechanism NULL, as-server 0, filler
GREETING = (b"\xff" + bytes(8) + b"\x7f" + bytes([3, 0])
            + b"NULL".ljust(20, b"\0") + b"\0" + bytes(31))
#: socket types each side accepts as a peer
_ACCEPTS = {b"PUB": (b"SUB", b"XSUB"), b"SUB": (b"PUB", b"XPUB")}
#: buffers handed to one ``sendmsg`` call
_IOV = 64
#: seconds between dials of an endpoint that did not answer (libzmq's
#: ``ZMQ_RECONNECT_IVL`` default)
RECONNECT_IVL_S = 0.1
_RECV_CHUNK = 1 << 20


class ProtocolError(Exception):
    """A peer broke the wire protocol; its connection is closed."""


def _frame(body: bytes, more: bool = False, command: bool = False) -> list:
    flags = (MORE if more else 0) | (COMMAND if command else 0)
    n = len(body)
    if n > 255:
        head = bytes([flags | LONG]) + n.to_bytes(8, "big")
    else:
        head = bytes([flags, n])
    return [head, body] if n else [head]


def _command(name: bytes, data: bytes = b"") -> list:
    return _frame(bytes([len(name)]) + name + data, command=True)


def _properties(props: dict[bytes, bytes]) -> bytes:
    return b"".join(bytes([len(k)]) + k + len(v).to_bytes(4, "big") + v
                    for k, v in props.items())


def _parse_properties(data: bytes) -> dict[bytes, bytes]:
    out, pos = {}, 0
    while pos < len(data):
        n = data[pos]
        name = data[pos + 1:pos + 1 + n]
        pos += 1 + n
        if pos + 4 > len(data):
            raise ProtocolError("truncated metadata property")
        size = int.from_bytes(data[pos:pos + 4], "big")
        out[name] = data[pos + 4:pos + 4 + size]
        pos += 4 + size
    if pos != len(data):
        raise ProtocolError("truncated metadata property")
    return out


def encode_message(parts: Iterable[bytes]) -> list:
    """A multipart message as the frames' buffers, in wire order."""
    parts = [p if isinstance(p, bytes) else bytes(p) for p in parts]
    if not parts:
        raise ValueError("a message has at least one part")
    out = []
    for i, p in enumerate(parts):
        out += _frame(p, more=i < len(parts) - 1)
    return out


def parse_endpoint(endpoint: str, bind: bool) -> tuple[int, object]:
    """``tcp://host:port`` or ``ipc://path`` → (address family,
    address). Raises ValueError for anything else."""
    scheme, sep, rest = endpoint.partition("://")
    if not sep or not rest:
        raise ValueError(f"malformed endpoint {endpoint!r}")
    if scheme == "ipc":
        return socket.AF_UNIX, rest
    if scheme != "tcp":
        raise ValueError(f"unsupported transport {scheme!r} in {endpoint!r}")
    host, sep, port = rest.rpartition(":")
    if not sep:
        raise ValueError(f"endpoint {endpoint!r} has no port")
    host = host.strip("[]")
    if host in ("*", ""):
        if not bind:
            raise ValueError(f"cannot connect to a wildcard: {endpoint!r}")
        host = "0.0.0.0"
    if port == "*":
        if not bind:
            raise ValueError(f"cannot connect to a wildcard: {endpoint!r}")
        port = "0"
    try:
        number = int(port)
    except ValueError:
        raise ValueError(f"bad port {port!r} in {endpoint!r}") from None
    if not 0 <= number <= 65535:
        raise ValueError(f"bad port {number} in {endpoint!r}")
    return socket.AF_INET, (host, number)


class _Peer:
    """One connection and its queues. ``wbufs`` (buffers being written)
    and ``rbuf`` belong to the I/O thread; ``ctrl`` (commands and
    subscriptions, never dropped), ``msgs`` (messages, at most the
    high-water mark) and ``subs`` are guarded by the socket's lock."""

    def __init__(self, sock: socket.socket, endpoint: str | None):
        self.sock = sock
        #: the endpoint this side dialled (redialled when it drops)
        self.endpoint = endpoint
        self.state = "greeting"
        self.events = 0
        self.rbuf = bytearray()
        self.wbufs: collections.deque = collections.deque()
        self.ctrl: collections.deque = collections.deque()
        self.msgs: collections.deque = collections.deque()
        self.parts: list[bytes] = []
        self.subs: collections.Counter = collections.Counter()

    def matches(self, topic: bytes) -> bool:
        return any(topic.startswith(p) for p in self.subs)


class _Socket:
    """The I/O machinery both socket types share."""

    kind = b""

    def __init__(self, hwm: int = 1000):
        if hwm < 1:
            raise ValueError("hwm must be at least 1")
        self.hwm = int(hwm)
        self._lock = threading.Lock()
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._woken = False
        #: work handed to the I/O thread (run there, in order)
        self._calls: collections.deque[Callable[[], None]] = collections.deque()
        self._listeners: dict[socket.socket, str | None] = {}
        self._peers: dict[socket.socket, _Peer] = {}
        #: peers through the handshake (guarded by ``_lock``)
        self._ready: list[_Peer] = []
        self._redial: list[tuple[float, str]] = []
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name=f"zmtp-{self.kind.decode().lower()}",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ API

    def bind(self, endpoint: str) -> str:
        """Listen on ``endpoint``; returns it with the port a ``*`` or
        ``0`` port resolved to. Raises OSError (address in use, ...) or
        ValueError (malformed endpoint) here, in the caller."""
        family, addr = parse_endpoint(endpoint, bind=True)
        sock = socket.socket(family, socket.SOCK_STREAM)
        try:
            if family == socket.AF_UNIX:
                try:
                    os.unlink(addr)
                except FileNotFoundError:
                    pass
            else:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(addr)
            sock.listen(64)
            sock.setblocking(False)
        except BaseException:
            sock.close()
            raise
        if family == socket.AF_UNIX:
            bound = endpoint
            path = addr
        else:
            host, port = sock.getsockname()[:2]
            bound = f"tcp://{addr[0]}:{port}"
            path = None
        self._call(lambda: self._listen(sock, path))
        log.debug("%s bound %s", self.kind.decode(), bound)
        return bound

    def connect(self, endpoint: str) -> None:
        """Dial ``endpoint`` from the I/O thread, and again every
        ``RECONNECT_IVL_S`` until a peer answers or whenever it goes
        away. A malformed endpoint raises ValueError here."""
        parse_endpoint(endpoint, bind=False)
        self._call(lambda: self._dial(endpoint))

    def peers(self) -> int:
        """Connections through the handshake."""
        with self._lock:
            return len(self._ready)

    def close(self) -> None:
        """Discard what is queued (``LINGER 0``), close every connection
        and listener, and join the I/O thread."""
        if self._closed:
            return
        self._closed = True
        self._wake()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            log.error("zmtp %s I/O thread did not stop", self.kind.decode())

    # ---------------------------------------------- hooks of the types

    def _on_ready(self, peer: _Peer) -> None:
        with self._lock:
            self._ready.append(peer)

    def _on_message(self, peer: _Peer, msg: list[bytes]) -> None:
        raise NotImplementedError

    def _on_subscription(self, peer: _Peer, subscribe: bool,
                         prefix: bytes) -> None:
        pass  # only a PUB takes subscriptions

    # --------------------------------------------------- I/O thread

    def _wake(self) -> None:
        with self._lock:
            if self._woken:
                return
            self._woken = True
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # a wake byte is already pending, or we are closing

    def _call(self, fn: Callable[[], None]) -> None:
        if self._closed:
            raise RuntimeError("socket is closed")
        self._calls.append(fn)
        self._wake()

    def _run(self) -> None:
        try:
            while not self._closed:
                while self._calls:
                    self._calls.popleft()()
                self._update_interest()
                timeout = None
                if self._redial:
                    timeout = max(0.0, min(d for d, _ in self._redial)
                                  - time.monotonic())
                for key, events in self._sel.select(timeout):
                    obj = key.data
                    if obj is None:
                        self._drain_wake()
                    elif isinstance(obj, _Peer):
                        if obj.sock not in self._peers:
                            continue  # dropped earlier in this round
                        if events & selectors.EVENT_WRITE:
                            self._on_writable(obj)
                        if (events & selectors.EVENT_READ
                                and obj.sock in self._peers):
                            self._on_readable(obj)
                    else:
                        self._accept(key.fileobj)
                self._due_redials()
        except Exception:  # noqa: BLE001 — the socket's thread boundary
            log.exception("zmtp %s I/O thread failed", self.kind.decode())
        finally:
            self._shutdown()

    def _shutdown(self) -> None:
        for peer in list(self._peers.values()):
            peer.sock.close()
        self._peers.clear()
        with self._lock:
            self._ready.clear()
        for sock, path in self._listeners.items():
            sock.close()
            if path is not None:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        self._listeners.clear()
        self._sel.close()
        self._wake_r.close()
        self._wake_w.close()

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except BlockingIOError:
            pass
        with self._lock:
            self._woken = False

    def _update_interest(self) -> None:
        for peer in self._peers.values():
            if peer.state == "connecting":
                want = selectors.EVENT_WRITE
            elif peer.wbufs or peer.ctrl or peer.msgs:
                want = selectors.EVENT_READ | selectors.EVENT_WRITE
            else:
                want = selectors.EVENT_READ
            if want != peer.events:
                self._sel.modify(peer.sock, want, peer)
                peer.events = want

    def _listen(self, sock: socket.socket, path: str | None) -> None:
        self._listeners[sock] = path
        self._sel.register(sock, selectors.EVENT_READ, "listener")

    def _accept(self, lsock: socket.socket) -> None:
        while True:
            try:
                conn, _ = lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                log.warning("zmtp accept failed: %s", exc)
                return
            self._start(_Peer(conn, None))

    def _dial(self, endpoint: str) -> None:
        family, addr = parse_endpoint(endpoint, bind=False)
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            err = sock.connect_ex(addr)
        except OSError as exc:  # e.g. a name that does not resolve
            err = exc.errno or errno.ECONNREFUSED
        if err in (0, errno.EINPROGRESS):
            peer = _Peer(sock, endpoint)
            if err:
                peer.state = "connecting"
                self._peers[sock] = peer
                self._sel.register(sock, selectors.EVENT_WRITE, peer)
                peer.events = selectors.EVENT_WRITE
            else:
                self._start(peer)
            return
        sock.close()
        self._redial.append((time.monotonic() + RECONNECT_IVL_S,
                             endpoint))

    def _due_redials(self) -> None:
        if not self._redial:
            return
        now = time.monotonic()
        due = [e for d, e in self._redial if d <= now]
        self._redial = [(d, e) for d, e in self._redial if d > now]
        for endpoint in due:
            self._dial(endpoint)

    def _start(self, peer: _Peer) -> None:
        """A connection is up: send the greeting, await the peer's."""
        sock = peer.sock
        sock.setblocking(False)
        if sock.family == socket.AF_INET:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        peer.state = "greeting"
        peer.wbufs.append(memoryview(GREETING))
        if sock not in self._peers:
            self._peers[sock] = peer
            self._sel.register(sock, selectors.EVENT_READ, peer)
            peer.events = selectors.EVENT_READ

    def _drop(self, peer: _Peer, why: str) -> None:
        log.debug("zmtp %s drops a peer: %s", self.kind.decode(), why)
        self._sel.unregister(peer.sock)
        peer.sock.close()
        del self._peers[peer.sock]
        with self._lock:
            if peer in self._ready:
                self._ready.remove(peer)
        if peer.endpoint is not None and not self._closed:
            self._redial.append((time.monotonic() + RECONNECT_IVL_S,
                                 peer.endpoint))

    def _on_writable(self, peer: _Peer) -> None:
        if peer.state == "connecting":
            err = peer.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self._drop(peer, os.strerror(err))
                return
            self._start(peer)
        while True:
            if not peer.wbufs:
                with self._lock:
                    while peer.ctrl:
                        peer.wbufs.extend(map(memoryview, peer.ctrl.popleft()))
                    for _ in range(_IOV):
                        if not peer.msgs:
                            break
                        peer.wbufs.extend(map(memoryview, peer.msgs.popleft()))
                if not peer.wbufs:
                    return
            try:
                sent = peer.sock.sendmsg(
                    list(itertools.islice(peer.wbufs, _IOV)))
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                self._drop(peer, str(exc))
                return
            while sent:
                head = peer.wbufs[0]
                if sent >= len(head):
                    sent -= len(head)
                    peer.wbufs.popleft()
                else:
                    peer.wbufs[0] = head[sent:]
                    sent = 0

    def _on_readable(self, peer: _Peer) -> None:
        try:
            data = peer.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as exc:
            self._drop(peer, str(exc))
            return
        if not data:
            self._drop(peer, "closed by the peer")
            return
        peer.rbuf += data
        try:
            self._parse(peer)
        except ProtocolError as exc:
            log.warning("zmtp %s: %s; closing the connection",
                        self.kind.decode(), exc)
            self._drop(peer, str(exc))

    def _parse(self, peer: _Peer) -> None:
        buf = peer.rbuf
        if peer.state == "greeting":
            if buf and buf[0] != 0xFF:
                raise ProtocolError("not a ZMTP 3 greeting")
            if len(buf) < len(GREETING):
                return
            if not buf[9] & 0x01:
                raise ProtocolError("not a ZMTP 3 greeting")
            if buf[10] < 3:
                raise ProtocolError(f"ZMTP {buf[10]}.x peers are not served")
            mechanism = bytes(buf[12:32]).rstrip(b"\0")
            if mechanism != b"NULL":
                raise ProtocolError(f"mechanism {mechanism!r} is not NULL")
            del buf[:len(GREETING)]
            peer.state = "handshake"
            with self._lock:
                peer.ctrl.append(_command(
                    b"READY", _properties({b"Socket-Type": self.kind})))
        pos, n = 0, len(buf)
        with memoryview(buf) as view:
            while n - pos >= 2:
                flags = buf[pos]
                if flags & LONG:
                    if n - pos < 9:
                        break
                    size = int.from_bytes(view[pos + 1:pos + 9], "big")
                    start = pos + 9
                else:
                    size = buf[pos + 1]
                    start = pos + 2
                end = start + size
                if end > n:
                    break
                body = view[start:end].tobytes()
                pos = end
                if flags & COMMAND:
                    self._on_command(peer, body)
                elif peer.state != "ready":
                    raise ProtocolError("a message before the handshake")
                else:
                    peer.parts.append(body)
                    if not flags & MORE:
                        msg, peer.parts = peer.parts, []
                        self._on_message(peer, msg)
        if pos:
            del buf[:pos]

    def _on_command(self, peer: _Peer, body: bytes) -> None:
        if not body or len(body) < 1 + body[0]:
            raise ProtocolError("truncated command")
        name, data = body[1:1 + body[0]], body[1 + body[0]:]
        if name == b"READY":
            if peer.state != "handshake":
                raise ProtocolError("READY out of turn")
            ptype = _parse_properties(data).get(b"Socket-Type")
            if ptype not in _ACCEPTS[self.kind]:
                raise ProtocolError(
                    f"a {self.kind.decode()} does not talk to {ptype!r}")
            peer.state = "ready"
            self._on_ready(peer)
        elif name == b"ERROR":
            reason = data[1:1 + data[0]] if data else b""
            raise ProtocolError(f"peer error {reason!r}")
        elif name == b"PING":
            with self._lock:
                peer.ctrl.append(_command(b"PONG", data[2:]))
        elif name in (b"SUBSCRIBE", b"CANCEL"):
            self._on_subscription(peer, name == b"SUBSCRIBE", data)
        # PONG and unknown commands are ignored (RFC 37)


class PubSocket(_Socket):
    """ZMTP PUB: fans each message out to the peers subscribed to a
    prefix of its first frame, dropping it for a peer at its high-water
    mark."""

    kind = b"PUB"

    def send_multipart(self, parts: Iterable[bytes]) -> int:
        """Queue one message for every matching peer; never blocks.
        Returns the number of peers it was dropped for (their queues
        held ``hwm`` messages). A message no peer subscribes to goes
        nowhere and counts as no drop, as in libzmq. Raises
        RuntimeError once the socket is closed or its I/O thread has
        died."""
        if self._closed or not self._thread.is_alive():
            raise RuntimeError("socket is closed")
        parts = [p if isinstance(p, bytes) else bytes(p) for p in parts]
        bufs = encode_message(parts)
        topic = parts[0]
        dropped = queued = 0
        with self._lock:
            for peer in self._ready:
                if not peer.matches(topic):
                    continue
                if len(peer.msgs) >= self.hwm:
                    dropped += 1
                else:
                    peer.msgs.append(bufs)
                    queued += 1
        if queued:
            self._wake()
        return dropped

    def subscribed_peers(self) -> int:
        """Peers through the handshake holding at least one
        subscription (a publisher may wait on it to avoid pub/sub's
        slow-joiner loss)."""
        with self._lock:
            return sum(1 for p in self._ready if p.subs)

    def _on_message(self, peer: _Peer, msg: list[bytes]) -> None:
        # ZMTP 3.0 subscriptions: one frame, 01 (or 00) then the prefix
        if len(msg) == 1 and msg[0] and msg[0][0] in (0, 1):
            self._on_subscription(peer, msg[0][0] == 1, msg[0][1:])

    def _on_subscription(self, peer: _Peer, subscribe: bool,
                         prefix: bytes) -> None:
        with self._lock:
            if subscribe:
                peer.subs[prefix] += 1
            elif peer.subs[prefix] > 1:
                peer.subs[prefix] -= 1
            else:
                peer.subs.pop(prefix, None)


class SubSocket(_Socket):
    """ZMTP SUB: sends its subscriptions to every peer, filters what
    arrives by them, and hands messages out through
    :meth:`recv_multipart`."""

    kind = b"SUB"

    def __init__(self, hwm: int = 1000, rcvtimeo_ms: int = -1):
        self.rcvtimeo_ms = rcvtimeo_ms
        self._subs: collections.Counter = collections.Counter()
        self._inbox: queue.Queue = queue.Queue(maxsize=hwm)
        #: messages dropped because the inbox held ``hwm`` of them
        self.dropped = 0
        super().__init__(hwm=hwm)

    def subscribe(self, prefix: bytes) -> None:
        self._change(prefix, True)

    def unsubscribe(self, prefix: bytes) -> None:
        self._change(prefix, False)

    def _change(self, prefix: bytes, subscribe: bool) -> None:
        prefix = bytes(prefix)
        with self._lock:
            if subscribe:
                self._subs[prefix] += 1
            elif self._subs[prefix] > 1:
                self._subs[prefix] -= 1
            elif prefix in self._subs:
                del self._subs[prefix]
            else:
                return
            for peer in self._ready:
                peer.ctrl.append(_frame(bytes([subscribe]) + prefix))
        self._wake()

    def recv_multipart(self) -> list[bytes] | None:
        """The next message, or ``None`` once ``rcvtimeo_ms`` passes
        (or at once when the socket is closed)."""
        if self._closed:
            return None
        timeout = None if self.rcvtimeo_ms < 0 else self.rcvtimeo_ms / 1e3
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def _on_ready(self, peer: _Peer) -> None:
        with self._lock:
            for prefix in self._subs:
                peer.ctrl.append(_frame(b"\x01" + prefix))
            self._ready.append(peer)

    def _on_message(self, peer: _Peer, msg: list[bytes]) -> None:
        topic = msg[0]
        with self._lock:
            wanted = any(topic.startswith(p) for p in self._subs)
        if not wanted:
            return
        try:
            self._inbox.put_nowait(msg)
        except queue.Full:
            self.dropped += 1
