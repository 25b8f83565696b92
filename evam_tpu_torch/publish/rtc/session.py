"""One WebRTC peer session: ICE-lite + DTLS-SRTP + VP8/RTP sender.

Counterpart of ``evam_tpu/publish/rtc/session.py``: the same session,
feedback rules and SDP on the port's layers. Four changes:
``RelayBgrSource`` decodes the relay's JPEG with the port's codec
(``media/jpeg.py``) instead of ``cv2.imdecode``; the SDP host
candidate's address is read from the host's interfaces rather than
from a UDP socket connected towards an outside address; the pump waits
for a datagram only until the next frame is due, so a session sends at
its ``fps`` (the reference's 0.2 s wait held a viewer that sends
nothing to 5 frames/s); and a session without a ``cert_dir`` removes
its certificate's temporary directory once DTLS has read it.

Wires the package's layers onto a single UDP socket (rtcp-mux,
BUNDLE): answers the browser's ICE connectivity checks, completes the
DTLS handshake in the passive role, derives SRTP send keys (RFC
5764), then encodes pipeline frames as VP8 keyframes and streams them
SRTP-protected to the nominated remote address. The session is the
media-plane counterpart of the reference's webrtcbin-based
destination (reference docker-compose.yml:51-52).
"""

from __future__ import annotations

import array
import fcntl
import logging
import os
import re
import socket
import struct
import tempfile
import threading
import time
from collections import OrderedDict

from evam_tpu_torch.media import jpeg
from evam_tpu_torch.publish.rtc import dtls, rtcp, srtp, stun, vp8

log = logging.getLogger("evam_tpu_torch.publish.rtc")

PAYLOAD_TYPE = 96
CLOCK_RATE = 90000


def parse_remote_sdp(sdp: str) -> dict:
    """The few offer fields the answering side uses."""
    out: dict = {}
    for pat, key in [
        (r"^a=ice-ufrag:(\S+)", "ufrag"),
        (r"^a=ice-pwd:(\S+)", "pwd"),
        (r"^a=fingerprint:sha-256 (\S+)", "fingerprint"),
        (r"^a=mid:(\S+)", "mid"),
    ]:
        m = re.search(pat, sdp, re.M)
        if m and key not in out:
            out[key] = m.group(1)
    return out


def build_answer_sdp(ip: str, port: int, ufrag: str, pwd: str,
                     fingerprint: str, ssrc: int,
                     mid: str = "0") -> str:
    """Minimal browser-compatible answer: ice-lite, passive DTLS,
    sendonly VP8 with a host candidate."""
    sess = int.from_bytes(os.urandom(4), "big")
    return "\r\n".join([
        "v=0",
        f"o=- {sess} 2 IN IP4 127.0.0.1",
        "s=-",
        "t=0 0",
        "a=ice-lite",
        f"a=group:BUNDLE {mid}",
        "a=msid-semantic: WMS evam",
        f"m=video {port} UDP/TLS/RTP/SAVPF {PAYLOAD_TYPE}",
        f"c=IN IP4 {ip}",
        f"a=mid:{mid}",
        "a=sendonly",
        f"a=ice-ufrag:{ufrag}",
        f"a=ice-pwd:{pwd}",
        f"a=fingerprint:sha-256 {fingerprint}",
        "a=setup:passive",
        "a=rtcp-mux",
        f"a=rtpmap:{PAYLOAD_TYPE} VP8/{CLOCK_RATE}",
        # advertise loss-recovery feedback so viewers send NACK/PLI
        f"a=rtcp-fb:{PAYLOAD_TYPE} nack",
        f"a=rtcp-fb:{PAYLOAD_TYPE} nack pli",
        f"a=rtcp-fb:{PAYLOAD_TYPE} ccm fir",
        f"a=ssrc:{ssrc} cname:evam-tpu",
        f"a=ssrc:{ssrc} msid:evam video0",
        f"a=candidate:1 1 udp 2130706431 {ip} {port} typ host",
        "a=end-of-candidates",
        "",
    ])


class RtcSession:
    """Answering media session for one viewer."""

    def __init__(self, frame_source=None, width: int = 640,
                 height: int = 360,
                 bind_ip: str = "0.0.0.0", advertise_ip: str | None = None,
                 cert_dir: str | None = None, fps: float = 15.0,
                 on_dead=None, connect_timeout_s: float = 30.0,
                 payload_source=None, video_mode: str = "key",
                 gop: int = 12, loss_keyframe_threshold: float = 0.10):
        """``frame_source() -> np.ndarray | None`` supplies BGR frames
        (the publish relay's latest frame) which this session encodes
        itself; ``payload_source() -> bytes | None`` supplies
        ready-made VP8 payloads instead (SharedVp8Source: one encode
        per relay frame shared across N viewers — the keyframe-only
        stream is viewer-independent). Exactly one must be given.
        ``on_dead(session)`` fires once when the pump thread exits for
        any reason — owners use it to release relay clients and
        registry slots.

        ``video_mode`` picks the encoder: ``"key"`` (every frame a
        keyframe — shareable across viewers, lowest latency) or
        ``"delta"`` (GOP-batched inter frames via ``Vp8GopEncoder``
        — ~40× lower bitrate, ``gop/fps`` s extra latency; only valid
        with ``frame_source``). Both modes answer viewer feedback:
        NACKed packets are retransmitted from the send cache, and
        PLI/FIR or an RR with ``fraction_lost`` ≥
        ``loss_keyframe_threshold`` forces the next frame to be a
        keyframe (a no-op in ``"key"`` mode where every frame
        already is one)."""
        if (frame_source is None) == (payload_source is None):
            raise ValueError(
                "give exactly one of frame_source / payload_source")
        if video_mode not in ("key", "delta"):
            raise ValueError(f"unknown video_mode {video_mode!r}")
        if video_mode == "delta" and frame_source is None:
            raise ValueError(
                "delta mode needs a frame_source (per-viewer encoder "
                "state cannot ride a shared payload_source)")
        self.frame_source = frame_source
        self.payload_source = payload_source
        self.width, self.height = width, height
        self.fps = fps
        self.ssrc = int.from_bytes(os.urandom(4), "big") & 0x7FFFFFFF
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((bind_ip, 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.ip = advertise_ip or _default_ip()
        if cert_dir is None:
            # a key of this session's own; the endpoint reads the PEMs
            # when it is made, so their directory goes at once (one left
            # per viewer would pile up)
            with tempfile.TemporaryDirectory(prefix="evam_rtc_") as d:
                cert, key, self.fingerprint = dtls.generate_certificate(d)
                self.dtls = dtls.DtlsEndpoint(cert, key, server=True)
        else:
            cert, key, self.fingerprint = dtls.generate_certificate(cert_dir)
            self.dtls = dtls.DtlsEndpoint(cert, key, server=True)
        self.ice = stun.IceLiteResponder()
        self.remote: dict = {}
        self.sender: srtp.SrtpSender | None = None
        self.connected = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.frames_sent = 0
        self.on_dead = on_dead
        self._dead_fired = False
        self._srtcp: rtcp.SrtcpSender | None = None
        self._rtp_packets = 0
        self._rtp_octets = 0
        self._last_sr = 0.0
        self.video_mode = video_mode
        self.gop = gop
        self.loss_keyframe_threshold = loss_keyframe_threshold
        #: seq → protected packet, for NACK retransmission. 512
        #: packets ≈ several seconds of preview video — beyond that a
        #: retransmit would arrive too late to matter anyway.
        self._sent_cache: "OrderedDict[int, bytes]" = OrderedDict()
        self._srtcp_rx: rtcp.SrtcpReceiver | None = None
        self._force_key = False
        self._last_loss_key = 0.0
        # feedback counters (observable in tests + /metrics)
        self.nacks_received = 0
        self.packets_retransmitted = 0
        self.plis_received = 0
        self.keyframes_forced = 0
        # ---- RR-driven rate adaptation: under
        # sustained reported loss the sender halves its frame rate
        # (down to 1/4) instead of hammering a congested path with
        # keyframes; clean reports recover it multiplicatively. The
        # browser-facing analogue of webrtcbin's congestion control
        # (reference docker-compose.yml:51-52), driven purely by RFC
        # 3550 receiver reports since the viewer owns the send rate.
        self.fps_scale = 1.0
        self.fps_scale_min = 0.25
        self.rate_adaptations = 0
        self._lossy_rrs = 0
        #: RTT from the RR's LSR/DLSR echo (RFC 3550 §6.4.1) and the
        #: receiver's interarrival jitter, both surfaced as session
        #: stats for monitoring (None until a compliant RR arrives)
        self.last_rtt_ms: float | None = None
        self.last_jitter_ms: float | None = None
        #: give up (and fire on_dead → relay release) if no viewer
        #: completes ICE+DTLS in this window — an unreachable host
        #: candidate must not pin encode cost forever
        self.connect_timeout_s = connect_timeout_s

    # ------------------------------------------------------ signaling

    def answer(self, offer_sdp: str) -> str:
        self.remote = parse_remote_sdp(offer_sdp)
        return build_answer_sdp(
            self.ip, self.port, self.ice.local_ufrag,
            self.ice.local_pwd, self.fingerprint, self.ssrc,
            mid=self.remote.get("mid", "0"),
        )

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"rtc-{self.port}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.sock.close()
        self.dtls.close()

    # ---------------------------------------------------------- pump

    def _run(self) -> None:
        try:
            self._pump()
        except Exception as exc:  # noqa: BLE001 — a dead session must
            # never take the signaler down, and must always fire
            # on_dead so the owner releases its relay client
            log.warning("rtc session udp:%d died: %s", self.port, exc)
        finally:
            self._fire_dead()

    def _fire_dead(self) -> None:
        if self._dead_fired:
            return
        self._dead_fired = True
        if self.on_dead is not None:
            try:
                self.on_dead(self)
            except Exception:  # noqa: BLE001
                pass

    def _pump(self) -> None:
        enc = None
        delta = None
        if self.payload_source is None:
            if self.video_mode == "delta":
                # GOP batch encode takes seconds — NEVER on the pump
                # thread (it would stall STUN/DTLS/NACK handling);
                # a dedicated encoder thread owns the Vp8GopEncoder
                delta = _DeltaEncoder(
                    self.width, self.height, self.gop, self._stop)
                delta.start()
            else:
                enc = vp8.Vp8Encoder(self.width, self.height)
        pk = vp8.Vp8Packetizer(self.ssrc, PAYLOAD_TYPE)
        last_dtls_progress = time.monotonic()
        next_frame_t = 0.0
        ts0 = int.from_bytes(os.urandom(4), "big") & 0xFFFFFF
        t_start = time.monotonic()
        try:
            while not self._stop.is_set():
                # wait for a datagram no longer than until the next
                # frame is due: a fixed 0.2 s would hold a viewer that
                # sends nothing to 5 frames/s
                wait = 0.2
                if self.sender is not None:
                    wait = min(wait, max(0.001,
                                         next_frame_t - time.monotonic()))
                self.sock.settimeout(wait)
                try:
                    data, addr = self.sock.recvfrom(4096)
                except socket.timeout:
                    data, addr = None, None
                except OSError:
                    break
                if data is not None:
                    if stun.is_stun(data):
                        resp = self.ice.handle(data, addr)
                        if resp is not None:
                            self.sock.sendto(resp, addr)
                    elif stun.is_dtls(data):
                        self.dtls.put_datagram(data)
                        last_dtls_progress = time.monotonic()
                    elif (len(data) >= 2 and 192 <= data[1] <= 223
                          and self._srtcp_rx is not None):
                        # rtcp-mux (RFC 5761): viewer feedback
                        self._handle_feedback(data)

                if self.ice.remote_addr is not None and not self.dtls.finished:
                    self.dtls.handshake_step()
                    for d in self.dtls.take_datagrams():
                        self.sock.sendto(d, self.ice.remote_addr)
                    if time.monotonic() - last_dtls_progress > 1.0:
                        self.dtls.handle_timeout()
                        last_dtls_progress = time.monotonic()

                if self.dtls.finished and self.sender is None:
                    # the SDP fingerprint is the peer's ONLY identity:
                    # a handshake from a cert that doesn't match the
                    # signaled offer is an impostor — tear down
                    want = (self.remote.get("fingerprint") or "").upper()
                    got = self.dtls.peer_fingerprint()
                    if not want or got != want:
                        raise RuntimeError(
                            f"DTLS peer fingerprint mismatch: "
                            f"offer={want[:20]}… peer="
                            f"{(got or 'none')[:20]}…")
                    key, salt, rk, rs = self.dtls.srtp_keys()
                    self.sender = srtp.SrtpSender(key, salt)
                    self._srtcp = rtcp.SrtcpSender(key, salt)
                    self._srtcp_rx = rtcp.SrtcpReceiver(rk, rs)
                    self.connected.set()
                    log.info("rtc: media up to %s (%s)",
                             self.ice.remote_addr,
                             self.dtls.selected_srtp_profile())

                if (not self.connected.is_set()
                        and time.monotonic() - t_start
                        > self.connect_timeout_s):
                    raise TimeoutError(
                        f"no viewer connected within "
                        f"{self.connect_timeout_s:.0f}s")

                now = time.monotonic()
                if (self.sender is not None
                        and self.ice.remote_addr is not None
                        and now >= next_frame_t):
                    next_frame_t = now + 1.0 / (self.fps * self.fps_scale)
                    payload = None
                    if delta is not None:
                        if self._force_key:
                            self._force_key = False
                            self.keyframes_forced += 1
                            delta.force_keyframe()
                        frame = self.frame_source()
                        if frame is not None:
                            delta.submit(frame)
                        payload = delta.next_payload()
                    elif enc is not None:
                        self._force_key = False  # every frame is one
                        frame = self.frame_source()
                        if frame is None:
                            continue
                        payload = enc.encode(frame)
                    else:
                        self._force_key = False
                        payload = self.payload_source()
                    if payload is None:
                        continue
                    ts = (ts0 + int((now - t_start) * CLOCK_RATE)) \
                        & 0xFFFFFFFF
                    for pkt in pk.packetize(payload, ts):
                        seq = int.from_bytes(pkt[2:4], "big")
                        protected = self.sender.protect(pkt)
                        self.sock.sendto(
                            protected, self.ice.remote_addr)
                        self._sent_cache[seq] = protected
                        while len(self._sent_cache) > 512:
                            self._sent_cache.popitem(last=False)
                        self._rtp_packets += 1
                        self._rtp_octets += len(pkt) - 12
                    self.frames_sent += 1
                    # compound SR+SDES every ~2 s (browser sync/stats)
                    if now - self._last_sr > 2.0:
                        self._last_sr = now
                        sr = rtcp.sender_report(
                            self.ssrc, ts, self._rtp_packets,
                            self._rtp_octets)
                        self.sock.sendto(
                            self._srtcp.protect(sr),
                            self.ice.remote_addr)
        finally:
            if enc is not None:
                enc.close()
            if delta is not None:
                delta.close()

    def _handle_feedback(self, data: bytes) -> None:
        """Unprotect + act on one inbound SRTCP compound. Forged or
        corrupt packets are dropped (unauthenticated feedback must
        never drive retransmission — amplification risk)."""
        try:
            plain = self._srtcp_rx.unprotect(data)
        except ValueError:
            return
        fb = rtcp.parse_feedback(plain, media_ssrc=self.ssrc)
        if fb["nack"]:
            self.nacks_received += 1
            for seq in fb["nack"]:
                pkt = self._sent_cache.get(seq & 0xFFFF)
                if pkt is not None and self.ice.remote_addr is not None:
                    # resend the identical protected packet: same SRTP
                    # index ⇒ same keystream, a plain dup on the wire
                    self.sock.sendto(pkt, self.ice.remote_addr)
                    self.packets_retransmitted += 1
        want_key = fb["pli"] or fb["fir"]
        if fb["pli"] or fb["fir"]:
            self.plis_received += 1
        lost = fb["fraction_lost"]
        if (not want_key and lost is not None
                and lost >= self.loss_keyframe_threshold):
            # heavy reported loss without an explicit PLI: refresh
            # the picture anyway, at most once per second
            now = time.monotonic()
            if now - self._last_loss_key > 1.0:
                self._last_loss_key = now
                want_key = True
        if want_key:
            self._force_key = True
        if fb["jitter"] is not None:
            self.last_jitter_ms = fb["jitter"] / 90.0   # 90 kHz clock
        if fb["lsr"]:
            # RTT = now_ntp_mid32 − LSR − DLSR (1/65536 s units)
            units = (rtcp.ntp_mid32() - fb["lsr"]
                     - (fb["dlsr"] or 0)) & 0xFFFFFFFF
            if units < 0x80000000:          # sane (non-wrapped) value
                self.last_rtt_ms = units * 1000.0 / 65536.0
        # ---- rate adaptation: two consecutive lossy RRs halve the
        # frame rate (AIMD-flavored: multiplicative decrease, gentle
        # multiplicative recovery on clean reports)
        if lost is not None:
            if lost >= self.loss_keyframe_threshold:
                self._lossy_rrs += 1
                if (self._lossy_rrs >= 2
                        and self.fps_scale > self.fps_scale_min):
                    self.fps_scale = max(
                        self.fps_scale_min, self.fps_scale * 0.5)
                    self.rate_adaptations += 1
                    self._lossy_rrs = 0
            else:
                self._lossy_rrs = 0
                if self.fps_scale < 1.0:
                    self.fps_scale = min(1.0, self.fps_scale * 1.25)


class _DeltaEncoder:
    """Dedicated encoder thread for delta-mode sessions.

    ``Vp8GopEncoder`` encodes a whole GOP per pass (seconds on small
    hosts); running it inline would freeze the session pump — no
    STUN/DTLS answers, no NACK retransmits — for the duration. The
    pump instead submits frames/force-keyframe commands to this
    thread and paces finished payloads out one per tick. Ordering is
    preserved because one thread owns both the command queue and the
    payload queue; a force command drains stale continuation deltas
    before the fresh keyframe lands.
    """

    def __init__(self, width: int, height: int, gop: int, stop_event):
        import queue as queue_mod
        import threading as threading_mod

        self.enc = vp8.Vp8GopEncoder(width, height, gop)
        self._cmds: "queue_mod.Queue" = queue_mod.Queue(maxsize=2 * gop)
        self._payloads: "queue_mod.Queue" = queue_mod.Queue()
        self._stop = stop_event
        #: close() must end the thread even when the pump died
        #: without the session-level stop event being set
        self._done = threading_mod.Event()
        self._thread = threading_mod.Thread(
            target=self._run, name="vp8-gop-enc", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def submit(self, frame) -> None:
        try:
            self._cmds.put_nowait(("frame", frame))
        except Exception:  # noqa: BLE001 — encoder behind: skip frame
            pass

    def force_keyframe(self) -> None:
        try:
            self._cmds.put_nowait(("force", None))
        except Exception:  # noqa: BLE001
            pass

    def next_payload(self):
        try:
            return self._payloads.get_nowait()
        except Exception:  # noqa: BLE001
            return None

    def _run(self) -> None:
        import queue as queue_mod

        while not (self._stop.is_set() or self._done.is_set()):
            try:
                cmd, arg = self._cmds.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            try:
                if cmd == "force":
                    # stale continuation deltas are useless to a
                    # receiver that just reported picture loss
                    while True:
                        try:
                            self._payloads.get_nowait()
                        except queue_mod.Empty:
                            break
                    self.enc.force_keyframe()
                else:
                    for p in self.enc.push(arg):
                        self._payloads.put(p)
            except Exception as exc:  # noqa: BLE001 — encoder failure
                log.warning("vp8 gop encoder error: %s", exc)

    def close(self) -> None:
        self._done.set()
        self._thread.join(timeout=5)
        self.enc.close()


class RelayBgrSource:
    """Generation-cursor JPEG→BGR decode over a ``FrameRelay``.

    THE relay-consumption protocol for media sessions — shared by
    ``SharedVp8Source`` (key mode) and the delta-mode per-viewer
    ``frame_source`` (publish/webrtc.py) so the timeout and
    stalled-pipeline resend rules can't diverge. ``frame()`` returns
    the latest decoded BGR frame (the previous one while the pipeline
    is stalled, None before the first frame); ``gen`` identifies it.
    """

    def __init__(self, relay, timeout: float = 0.5):
        self.relay = relay
        self.timeout = timeout
        self.gen = 0
        self._frame = None

    def frame(self):
        data, gen = self.relay.next_frame(self.gen, timeout=self.timeout)
        if data is not None and gen != self.gen:
            try:
                frame = jpeg.decode(data)
            except ValueError:
                frame = None  # what cv2.imdecode's None was: skip it
            if frame is not None:
                self._frame, self.gen = frame, gen
        return self._frame


class SharedVp8Source:
    """One VP8 encode per relay frame, shared by every viewer session.

    The stream is keyframe-only (vp8.Vp8Encoder), so the payload is
    identical for all viewers; each session applies only its own RTP
    seq/timestamp and SRTP protection. N viewers cost one encode,
    not N. ``encodes`` counts the encodes."""

    def __init__(self, relay, width: int = 640, height: int = 360):
        import threading as _t

        self.src = RelayBgrSource(relay)
        self.enc = vp8.Vp8Encoder(width, height)
        self._lock = _t.Lock()
        self._enc_gen = 0
        self._payload: bytes | None = None
        self.encodes = 0

    def payload(self) -> bytes | None:
        frame = self.src.frame()
        if frame is None:
            return self._payload  # stalled pipeline: resend last
        with self._lock:
            if self.src.gen != self._enc_gen:
                self._payload = self.enc.encode(frame)
                self._enc_gen = self.src.gen
                self.encodes += 1
        return self._payload

    def close(self) -> None:
        self.enc.close()


def _default_ip() -> str:
    """The host's first non-loopback IPv4 address for the SDP host
    candidate (127.0.0.1 where it has none), read from its interfaces
    (``SIOCGIFADDR``) without sending or connecting anything."""
    siocgifaddr = 0x8915
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for _, name in socket.if_nameindex():
            req = array.array("B", struct.pack("256s", name.encode()[:15]))
            try:
                fcntl.ioctl(s.fileno(), siocgifaddr, req)
            except OSError:
                continue  # no IPv4 address on this interface
            ip = socket.inet_ntoa(req.tobytes()[20:24])
            if not ip.startswith("127."):
                return ip
        return "127.0.0.1"
    finally:
        s.close()
