"""WebRTC destination: signalling client + real media plane.

Counterpart of ``evam_tpu/publish/webrtc.py``. The reference enables a
WebRTC frame destination by pointing at an external signalling server
(``ENABLE_WEBRTC`` + ``WEBRTC_SIGNALING_SERVER`` ws endpoint,
reference docker-compose.yml:51-52). This client registers each stream
there and serves viewers two ways:

* **SDP offer/answer → real WebRTC media** (``publish/rtc/``): the peer
  sends ``{"type": "offer", "sdp": ...}``; we answer with an ice-lite
  + DTLS-passive SDP and stream SRTP-protected VP8 over UDP straight
  to the viewer (STUN/DTLS/SRTP/RTP on the system OpenSSL through
  ctypes and the port's own VP8 encoder).
* **ws-MJPEG fallback** for minimal viewers: ``{"type": "play"}`` →
  binary JPEG frames over the websocket itself.

Protocol (JSON text frames, binary for media):
  -> {"type": "register", "stream": <name>}
  <- {"type": "offer", "stream": <name>, "sdp": <offer>, "peer": id}
  -> {"type": "answer", "stream": <name>, "sdp": <answer>, "peer": id}
     (then SRTP media flows peer-to-peer over UDP)
  <- {"type": "bye", "stream": <name>, "peer": id}   # viewer gone
  <- {"type": "play", "stream": <name>}    # MJPEG fallback
  -> binary JPEG frames until
  <- {"type": "stop", "stream": <name>}

The reference runs the client on asyncio and the ``websockets``
package; the port runs it on a thread over its own websockets
(``rtc/ws.py``), with the same reconnect back-off (1 s doubling to
30 s) and the same relay-client accounting: each media session and a
``play`` hold one client of the relay, released exactly once.
"""

from __future__ import annotations

import json
import logging
import threading

from evam_tpu_torch.publish.rtc import ws as wslib
from evam_tpu_torch.publish.rtsp import FrameRelay

log = logging.getLogger("evam_tpu_torch.publish.webrtc")


class WebRtcSignaler:
    def __init__(self, server_url: str, stream: str, relay: FrameRelay,
                 video_mode: str = "key"):
        """``video_mode``: "key" (shared keyframe-only encoder) or
        "delta" (per-viewer GOP delta sessions) — plumbed from
        ``Settings.webrtc_video_mode`` (EVAM_WEBRTC_VIDEO_MODE)."""
        self.server_url = server_url
        self.stream = stream
        self.relay = relay
        self.video_mode = video_mode
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._ws: wslib.WebSocket | None = None
        #: peer id -> live RtcSession (SDP-negotiated viewers);
        #: guarded by _sessions_lock (ws thread vs pump on_dead)
        self._sessions: dict = {}
        self._sessions_lock = threading.Lock()
        #: lazily-created shared VP8 encoder (SharedVp8Source)
        self._vp8 = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"webrtc-{self.stream}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        ws = self._ws
        if ws is not None:
            ws.close(1001)  # wakes the client thread
        if self._thread is not None:
            self._thread.join(timeout=5)
        for peer in list(self._sessions):
            self._drop_session(peer)
        if self._vp8 is not None:
            self._vp8.close()
            self._vp8 = None

    @property
    def sessions(self) -> dict:
        """peer id → live session (a copy)."""
        with self._sessions_lock:
            return dict(self._sessions)

    def _drop_session(self, peer: str) -> None:
        """Stop + forget one media session, releasing its relay client
        exactly once (idempotent: callable from 'bye', from the
        session's on_dead, and from stop())."""
        with self._sessions_lock:
            sess = self._sessions.pop(peer, None)
            if sess is None:
                return
            self.relay.remove_client()
        try:
            sess.stop()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass

    def _rtc_answer(self, offer_sdp: str, peer: str) -> str | None:
        """Create a media session for one viewer; returns answer SDP."""
        try:
            from evam_tpu_torch.publish.rtc.session import (
                RelayBgrSource,
                RtcSession,
                SharedVp8Source,
            )
        except Exception as exc:  # noqa: BLE001 — as the reference logs it
            log.warning("webrtc media plane unavailable: %s", exc)
            return None
        # renegotiation: a fresh offer for a peer replaces (and stops)
        # its previous session, keeping the relay client count balanced
        self._drop_session(peer)
        try:
            if self.video_mode == "delta":
                # per-viewer GOP encoder (delta frames need private
                # encoder state), at gop/fps extra latency
                sess = RtcSession(
                    frame_source=RelayBgrSource(self.relay).frame,
                    video_mode="delta",
                    on_dead=lambda s, _p=peer: self._on_session_dead(
                        _p, s),
                )
            else:
                if self._vp8 is None:
                    # one encoder for every viewer of this stream (the
                    # keyframe-only payload is viewer-independent)
                    self._vp8 = SharedVp8Source(self.relay)
                sess = RtcSession(
                    payload_source=self._vp8.payload,
                    on_dead=lambda s, _p=peer: self._on_session_dead(
                        _p, s),
                )
            answer = sess.answer(offer_sdp)
            with self._sessions_lock:
                self.relay.add_client()  # producers keep encoding
                self._sessions[peer] = sess
            sess.start()
            log.info("webrtc: media session for peer %s on udp:%d",
                     peer, sess.port)
            return answer
        except Exception as exc:  # noqa: BLE001 — answer failure ≠ crash
            log.warning("webrtc: offer handling failed: %s", exc)
            return None

    def _on_session_dead(self, peer: str, sess) -> None:
        """A session's pump thread exited (error or stop): release the
        relay client unless a renegotiation already replaced it.
        Check-and-pop under the lock so a concurrent 'bye' can't make
        the relay count go down twice for one session."""
        with self._sessions_lock:
            if self._sessions.get(peer) is not sess:
                return
            self._sessions.pop(peer, None)
            self.relay.remove_client()

    def _run(self) -> None:
        backoff = 1.0
        while not self._stop.is_set():
            try:
                self._ws = wslib.connect(self.server_url)
                if self._stop.is_set():
                    self._ws.close(1001)
                    return
                backoff = 1.0
                self._serve(self._ws)
            except Exception as exc:  # noqa: BLE001 — reconnect loop
                if self._stop.is_set():
                    return
                log.warning("webrtc signaling (%s); retry in %.0fs",
                            exc, backoff)
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 30.0)
            finally:
                ws, self._ws = self._ws, None
                if ws is not None:
                    ws.close()

    def _serve(self, ws: wslib.WebSocket) -> None:
        """One connection: register, then answer the relay's messages
        (and stream JPEGs while a ``play`` holds)."""
        ws.send(json.dumps({"type": "register", "stream": self.stream}))
        log.info("webrtc: registered %s at %s", self.stream, self.server_url)
        playing = False
        gen = 0
        try:
            while not self._stop.is_set():
                if playing:
                    jpeg, gen = self.relay.next_frame(gen, 0.5)
                    if jpeg is not None:
                        ws.send(jpeg)
                    msg = ws.recv(timeout=0.001)
                else:
                    msg = ws.recv(timeout=0.5)
                if msg is None or isinstance(msg, bytes):
                    continue
                data = json.loads(msg)
                if data.get("stream") not in (None, self.stream):
                    continue
                if data.get("type") == "offer":
                    peer = str(data.get("peer", "0"))
                    answer = self._rtc_answer(data.get("sdp", ""), peer)
                    if answer is not None:
                        ws.send(json.dumps({
                            "type": "answer",
                            "stream": self.stream,
                            "peer": peer,
                            "sdp": answer,
                        }))
                elif data.get("type") == "bye":
                    self._drop_session(str(data.get("peer", "0")))
                elif data.get("type") == "play" and not playing:
                    playing = True
                    self.relay.add_client()
                elif data.get("type") == "stop" and playing:
                    playing = False
                    self.relay.remove_client()
        finally:
            if playing:
                self.relay.remove_client()
