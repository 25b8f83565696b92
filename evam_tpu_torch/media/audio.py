"""Audio sources: WAV files and synthetic tones (counterpart of
``evam_tpu/media/audio.py``).

The reference's audio path is ``decodebin ! audioresample !
audioconvert ! audio/x-raw,channels=1,format=S16LE,rate=16000``
(pipelines/audio_detection/environment/pipeline.json:4-5): sources
emit mono S16LE 16 kHz chunks as FrameEvents with ``audio`` payloads.
"""

from __future__ import annotations

import time
import wave
from typing import Iterator

import numpy as np

from evam_tpu_torch.media.source import NS, FrameEvent

RATE = 16000


class WavSource:
    """Reads a WAV file (standard-library ``wave``), converting to
    16 kHz mono S16LE."""

    def __init__(self, uri: str, chunk_ms: int = 100, loop: bool = False,
                 realtime: bool = False):
        self.path = uri[len("file://"):] if uri.startswith("file://") else uri
        self.chunk = int(RATE * chunk_ms / 1000)
        self.loop = loop
        self.realtime = realtime
        self._closed = False

    def _read_all(self) -> np.ndarray:
        with wave.open(self.path, "rb") as w:
            rate = w.getframerate()
            channels = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        if width == 2:
            samples = np.frombuffer(raw, np.int16)
        elif width == 1:
            samples = (np.frombuffer(raw, np.uint8).astype(np.int16) - 128) * 256
        else:
            raise ValueError(f"unsupported sample width {width}")
        if channels > 1:
            samples = samples.reshape(-1, channels).mean(axis=1).astype(np.int16)
        if rate != RATE:
            # nearest-sample resample, as the reference's host path does
            idx = np.clip(
                (np.arange(int(len(samples) * RATE / rate)) * rate / RATE
                 ).astype(np.int64),
                0, len(samples) - 1,
            )
            samples = samples[idx]
        return samples

    def frames(self) -> Iterator[FrameEvent]:
        samples = self._read_all()
        if len(samples) < self.chunk:
            return  # shorter than one chunk: nothing to emit, even looped
        seq = 0
        t_wall = time.perf_counter()
        while not self._closed:
            for off in range(0, len(samples) - self.chunk + 1, self.chunk):
                if self._closed:
                    return
                yield FrameEvent(
                    frame=None,
                    audio=samples[off:off + self.chunk],
                    pts_ns=seq * int(NS * self.chunk / RATE),
                    seq=seq,
                )
                seq += 1
                if self.realtime:
                    t_wall += self.chunk / RATE
                    delay = t_wall - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
            if not self.loop:
                return

    def close(self) -> None:
        self._closed = True


class SyntheticAudioSource:
    """Deterministic tones (``synthetic-audio://seconds=5&seed=0``): a
    sine at 440 × (1 + seed % 5) Hz, amplitude 12000."""

    def __init__(self, seconds: float = 5.0, chunk_ms: int = 100,
                 seed: int = 0):
        self.total = int(seconds * RATE)
        self.chunk = int(RATE * chunk_ms / 1000)
        self.seed = seed
        self._closed = False

    @classmethod
    def from_uri(cls, uri: str) -> "SyntheticAudioSource":
        body = uri.split("://", 1)[1]
        params = dict(p.split("=", 1) for p in body.split("&") if "=" in p)
        return cls(
            seconds=float(params.get("seconds", 5.0)),
            seed=int(params.get("seed", 0)),
        )

    def frames(self) -> Iterator[FrameEvent]:
        t = np.arange(self.total) / RATE
        freq = 440.0 * (1 + self.seed % 5)
        wavef = (np.sin(2 * np.pi * freq * t) * 12000).astype(np.int16)
        seq = 0
        for off in range(0, self.total - self.chunk + 1, self.chunk):
            if self._closed:
                return
            yield FrameEvent(
                frame=None,
                audio=wavef[off:off + self.chunk],
                pts_ns=seq * int(NS * self.chunk / RATE),
                seq=seq,
            )
            seq += 1

    def close(self) -> None:
        self._closed = True
