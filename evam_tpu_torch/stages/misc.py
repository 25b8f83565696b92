"""Format and windowing stages (counterpart of ``evam_tpu/stages/misc.py``).

The engine's preprocess does color and resize on the device, so the
reference's videoconvert/caps elements reduce to a pass-through, while
the audio elements keep their buffering semantics
(pipelines/audio_detection/environment/pipeline.json).
"""

from __future__ import annotations

import numpy as np

from evam_tpu_torch.stages.base import Stage
from evam_tpu_torch.stages.context import FrameContext


class ConvertStage(Stage):
    """videoconvert / caps-filter counterpart: format negotiation is part
    of the engine's preprocess, so this validates and passes through."""

    def __init__(self, name: str, properties: dict | None = None):
        self.name = name
        self.properties = properties or {}

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        return [ctx]


class AudioMixStage(Stage):
    """audiomixer counterpart: re-chunks audio into
    ``output-buffer-duration`` windows (ns, default 100000000 = 100 ms),
    each a new context with its own pts and seq."""

    def __init__(self, name: str, properties: dict | None = None):
        self.name = name
        props = properties or {}
        duration_ns = int(props.get("output-buffer-duration", 100_000_000))
        self.chunk = max(1, int(16000 * duration_ns / 1_000_000_000))
        self._buffer = np.zeros(0, np.int16)
        self._pts_ns = 0
        self._seq = 0

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        if ctx.audio is None:
            return [ctx]
        self._buffer = np.concatenate([self._buffer, ctx.audio])
        out: list[FrameContext] = []
        while len(self._buffer) >= self.chunk:
            chunk = self._buffer[:self.chunk]
            self._buffer = self._buffer[self.chunk:]
            out.append(FrameContext(
                frame=None,
                pts_ns=self._pts_ns,
                seq=self._seq,
                stream_id=ctx.stream_id,
                source_uri=ctx.source_uri,
                audio=chunk,
            ))
            self._pts_ns += int(self.chunk / 16000 * 1_000_000_000)
            self._seq += 1
        return out


class LevelStage(Stage):
    """level counterpart: RMS and peak in dB of each chunk, attached as
    a message when ``post-messages`` is set."""

    def __init__(self, name: str, properties: dict | None = None):
        self.name = name
        props = properties or {}
        self.post_messages = bool(props.get("post-messages", False))

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        if ctx.audio is not None and self.post_messages:
            x = ctx.audio.astype(np.float64) / 32768.0
            rms = float(np.sqrt(np.mean(np.square(x)) + 1e-12))
            peak = float(np.max(np.abs(x)))
            ctx.messages.append(
                {"level": {"rms_db": 20 * np.log10(max(rms, 1e-9)),
                           "peak_db": 20 * np.log10(max(peak, 1e-9))}})
        return [ctx]
