"""The WebRTC signalling relay between publishing services and viewers.

Counterpart of ``tools/signaling_server.py`` (the reference's relay,
on the ``websockets`` package), on the port's own websockets
(``ws.py``), one thread a connection. The same protocol (JSON text
frames):

  service -> {"type": "register", "stream": s}
  viewer  -> {"type": "watch", "stream": s, "sdp": <offer>}
  relay   -> service: {"type": "offer", "stream": s, "peer": id,
                        "sdp": <offer>}
  service -> {"type": "answer", "stream": s, "peer": id,
               "sdp": <answer>}
  relay   -> viewer: {"type": "answer", "sdp": <answer>}
  (media then flows service→viewer directly over SRTP/UDP)

A watch for a stream no service registered answers ``{"type":
"error", ...}``; a viewer that disconnects makes the relay send its
service ``{"type": "bye", "stream": s, "peer": id}``.

One addition to the reference's relay, which drops every binary frame:
it carries the signaler's ws-MJPEG fallback (``publish/webrtc.py``),
which no relay of the repository could drive before. A viewer's
``{"type": "play", "stream": s}`` reaches the service when it is the
stream's first player, the service's binary frames (JPEGs) go to every
player of its stream, and the last player's ``{"type": "stop"}`` or
disconnect sends the service ``{"type": "stop", "stream": s}``. A
binary frame from a viewer is still dropped.

Run: ``python -m evam_tpu_torch.publish.rtc.signaling [--host H]
[--port P]``; the first line of its output is ``signaling on
ws://H:P`` (``--port 0`` picks a free port). SIGTERM or SIGINT stops
it with exit 0.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import signal
import sys
import threading

from evam_tpu_torch.publish.rtc.ws import ConnectionClosed, WebSocket, WsServer

log = logging.getLogger("evam_tpu_torch.publish.rtc.signaling")


class SignalingServer:
    """The relay on ``host:port`` (0: any free port)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8443):
        self.host = host
        self.services: dict[str, WebSocket] = {}   # stream -> service
        self.viewers: dict[str, WebSocket] = {}    # peer id -> viewer
        self.players: dict[str, set[WebSocket]] = {}  # stream -> players
        self._peer_ids = itertools.count(1)
        self._lock = threading.Lock()
        self._server = WsServer(host, port, self._handle)
        self.port = self._server.port

    @property
    def url(self) -> str:
        return f"ws://{self.host}:{self.port}"

    def start(self) -> "SignalingServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()

    def _play(self, ws: WebSocket, stream: str, on: bool) -> None:
        """Add or remove one player of ``stream``; the service hears
        ``play`` for the first and ``stop`` after the last."""
        with self._lock:
            players = self.players.setdefault(stream, set())
            before = bool(players)
            (players.add if on else players.discard)(ws)
            after = bool(players)
            if not players:
                del self.players[stream]
            svc = self.services.get(stream)
        if svc is not None and before != after:
            self._send(svc, {"type": "play" if on else "stop",
                             "stream": stream})

    def _handle(self, ws: WebSocket) -> None:
        role, stream, peer = None, None, None
        playing: str | None = None
        try:
            while True:
                raw = ws.recv()
                if isinstance(raw, bytes):
                    if role == "service":  # the MJPEG fallback's frames
                        with self._lock:
                            players = list(self.players.get(stream, ()))
                        for player in players:
                            self._send(player, raw)
                    continue
                msg = json.loads(raw)
                t = msg.get("type")
                if t == "register":
                    role, stream = "service", msg["stream"]
                    with self._lock:
                        self.services[stream] = ws
                        replay = bool(self.players.get(stream))
                    log.info("service registered: %s", stream)
                    if replay:  # a service back after a reconnect
                        self._send(ws, {"type": "play", "stream": stream})
                elif t == "watch":
                    role, stream = "viewer", msg["stream"]
                    peer = str(next(self._peer_ids))
                    with self._lock:
                        self.viewers[peer] = ws
                        svc = self.services.get(stream)
                    if svc is None:
                        ws.send(json.dumps(
                            {"type": "error",
                             "message": f"no such stream {stream}"}))
                        continue
                    self._send(svc, {"type": "offer", "stream": stream,
                                     "peer": peer, "sdp": msg["sdp"]})
                elif t == "answer":
                    with self._lock:
                        viewer = self.viewers.get(str(msg.get("peer")))
                    if viewer is not None:
                        self._send(viewer, {"type": "answer",
                                            "sdp": msg["sdp"]})
                elif t == "play" and playing is None:
                    playing = msg["stream"]
                    self._play(ws, playing, True)
                elif t == "stop" and playing is not None:
                    self._play(ws, playing, False)
                    playing = None
        except ConnectionClosed:
            pass
        except (ValueError, KeyError, TypeError, AttributeError) as exc:
            log.warning("signaling: dropping a connection: %r", exc)
        finally:
            if playing is not None:
                self._play(ws, playing, False)
            with self._lock:
                if role == "service" and self.services.get(stream) is ws:
                    del self.services[stream]
                svc = None
                if peer is not None:
                    self.viewers.pop(peer, None)
                    svc = self.services.get(stream)
            if svc is not None:
                self._send(svc, {"type": "bye", "stream": stream,
                                 "peer": peer})

    @staticmethod
    def _send(ws: WebSocket, msg) -> None:
        """To another party (a dict as JSON text, bytes as binary): its
        failure ends its own handler, not this one."""
        try:
            ws.send(msg if isinstance(msg, bytes) else json.dumps(msg))
        except ConnectionClosed:
            pass


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8443)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    server = SignalingServer(args.host, args.port).start()
    print(f"signaling on ws://{args.host}:{server.port}", flush=True)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    while not done.wait(1.0):
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
